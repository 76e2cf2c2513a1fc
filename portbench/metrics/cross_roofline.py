"""The cross kernels' share of their roofline in the traced training
window, forward and backward, at the configuration's element size: the
least time of the launches the traced epochs make (a forward and a
backward a step on the batch, a forward a val chunk), the larger of FLOPs
over 67 TFLOP/s and bytes over 3.35 TB/s, over the device time of the
``cross_fwd*`` and ``cross_bwd_kernel`` launches. A trace that shows fewer
than four fifths of either, or more, gives nothing."""

from portbench import work


def read(ctx: dict):
    tr, e = ctx.get("trace"), ctx.get("traced_epochs", 0)
    if tr is None or not e:
        return None
    fwd, bwd = tr.kernels("cross_fwd"), tr.kernels("cross_bwd_kernel")
    steps, B, chunks = ctx["steps_per_epoch"], ctx["batch"], ctx["val_chunks"]
    want_fwd, want_bwd = e * (steps + len(chunks)), e * steps
    for got, want in ((fwd, want_fwd), (bwd, want_bwd)):
        if not got or len(got) < 0.8 * want or len(got) > want:
            return None
    w = ctx["widths"]
    elem = work.ELEM[ctx["dtype"]]
    one = lambda b, kind: work.least_s(*work.cross_work(b, w["d"], w["L"], kind, elem))  # noqa: E731
    least = e * (steps * (one(B, "fwd") + one(B, "bwd")) + sum(one(c, "fwd") for c in chunks))
    spent = sum(fwd) * want_fwd / len(fwd) + sum(bwd) * want_bwd / len(bwd)
    return 100.0 * least / spent
