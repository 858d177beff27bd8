"""The plain reference and the control. Plain PyTorch and NumPy: nothing of
the program, of JAX or of the JAX package is imported here, and nothing the
program made is read, only the rows, queries and mutations the harness
generated and handed to both sides, and the program's answers to judge."""
