"""The fused eval tower's share of its roofline in the traced window: the
least time of its launches (the larger of FLOPs over 67 TFLOP/s and bytes
over 3.35 TB/s, each launch on the rows of its 64 requests' cities) over
the device time of ``tower_eval_kernel``. One launch a batch; a trace that
shows fewer than four fifths of them, or more, gives nothing."""

from portbench import work


def read(ctx: dict):
    tr, n = ctx.get("trace"), ctx.get("traced_batches", 0)
    if tr is None or not n:
        return None
    times = tr.kernels("tower_eval_kernel")
    if not times or len(times) < 0.8 * n or len(times) > n:
        return None
    w = ctx["widths"]
    rows = ctx["traced_rows"] / n
    least = n * work.least_s(*work.tower_work(rows, w["d"], w["H"], w["R"], w["L"]))
    return 100.0 * least / (sum(times) * n / len(times))
