"""Share of the device's busy time spent inside ``moe_apply`` (the
harness's range around each call of the MoE layer)."""


def read(ctx):
    t = ctx.get("trace")
    r = t and t["ranges"].get("pb.moe")
    if not r or t["busy_s"] <= 0:
        return None
    return 100.0 * r["device_ms"] / 1e3 / t["busy_s"]
