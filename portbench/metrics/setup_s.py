"""setup_s: from the process's start (imports included) to the window's
opening: data, index, add, seals, warm-up and the load's lead."""


def read(ctx):
    return ctx.setup_s
