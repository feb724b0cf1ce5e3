"""Mean host ms of the train loop's ``train.advance`` spans in the
window (its ``Timeline``): the step's phase on the elastic runtime,
every live worker's signal and the skip-list protocol to quiescence,
and at a boundary the next epoch's derivation."""


def read(ctx):
    d = [e["dur"] for e in ctx.get("spans", ()) if e["name"] == "train.advance"]
    return sum(d) / len(d) / 1e3 if d else None
