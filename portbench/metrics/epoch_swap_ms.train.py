"""Mean host ms of the train loop's ``epoch.relower`` spans in the
window (its ``Timeline``): the boundary's swap to the next epoch's
step."""


def read(ctx):
    d = [e["dur"] for e in ctx.get("spans", ()) if e["name"] == "epoch.relower"]
    return sum(d) / len(d) / 1e3 if d else None
