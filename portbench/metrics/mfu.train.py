"""The training step's share of the card's peak in the configuration's
compute dtype (67 TFLOP/s float32, 989 TFLOP/s bfloat16): forward and
backward FLOPs (three forwards) a row times the rows stepped in the
window, over the window's wall seconds."""

from portbench import work


def read(ctx: dict):
    w = ctx["widths"]
    flops = 3.0 * work.dcnr_forward_flops(w["d"], w["H"], w["R"], w["L"]) * ctx["rows_stepped"]
    return 100.0 * flops / ctx["window_s"] / work.PEAK_FLOPS[ctx["dtype"]]
