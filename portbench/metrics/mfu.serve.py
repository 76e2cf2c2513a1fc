"""The serving step's share of the card's float32 peak: eval FLOPs of the
DCN-R a row (counted from the widths) times the rows ranked in the window
(each request's city), over the window's wall seconds."""

from portbench import work


def read(ctx: dict):
    w = ctx["widths"]
    flops = work.dcnr_forward_flops(w["d"], w["H"], w["R"], w["L"]) * ctx["rows_scored"]
    return 100.0 * flops / ctx["window_s"] / work.PEAK_FLOPS[ctx["dtype"]]
