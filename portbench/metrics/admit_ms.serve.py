"""Mean host ms of a bulk admission group in the window: the harness's
wrap of the engine's ``_admit_bulk``, from its call to its return,
which follows the host's read of the group's first tokens."""


def read(ctx):
    a = ctx.get("admit_s")
    return 1e3 * sum(a) / len(a) if a else None
