"""Reductions that several per-layer metrics share. Each returns None where
the run has nothing to read (no traced session, no launch of the kernel)."""

import statistics

from portbench.counts import knn_bytes, lfa_bound, model_flops, peaks

#: device events of the exact self-KNN kernel B1 (its box pass and walk)
B1 = ("knn_cull_kernel", "knn_box_kernel")
#: device events of the fused LFA kernels B2 and B3
LFA = ("lfa_round1", "lfa_pool2")
#: device events of row gathers (index_select, advanced indexing, gather)
GATHERS = ("gather_kernel", "indexSelect", "index_elementwise_kernel")


def median_ms(r):
    return statistics.median(r.call_s) * 1e3 if r.call_s else None


def idle_pct(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return (1.0 - r.trace.busy_s / r.trace.window_s) * 100.0


def forward_mfu_pct(r):
    """Model FLOPs of the traced clouds' forwards over the traced window, as a
    share of the card's float32 peak."""
    if r.trace is None or not r.traced_clouds:
        return None
    flops = model_flops.forward(r.config, r.config["n_points"]) * r.traced_clouds
    return flops / r.trace.window_s / peaks.F32_OPS_PER_S * 100.0


def knn_roofline_pct(r, clouds=None):
    """B1's byte bound for the traced clouds over its device time."""
    if r.trace is None:
        return None
    t = r.trace.device_s(B1)
    if t <= 0:
        return None
    clouds = r.traced_clouds if clouds is None else clouds
    nbytes = knn_bytes.forward(r.config, r.config["n_points"]) * clouds
    return nbytes / peaks.BYTES_PER_S / t * 100.0


def lfa_roofline_pct(r, clouds=None):
    """B2 and B3's least time for the traced clouds over their device time."""
    if r.trace is None:
        return None
    t = r.trace.device_s(LFA)
    if t <= 0:
        return None
    clouds = r.traced_clouds if clouds is None else clouds
    return lfa_bound.forward_s(r.config, r.config["n_points"]) * clouds / t * 100.0


def gather_ms_per_call(r):
    if r.trace is None or not r.traced_calls:
        return None
    t = r.trace.device_s(GATHERS)
    return t / r.traced_calls * 1e3 if t > 0 else None


def train_forward_clouds(r):
    """Cloud forwards in the traced epoch: each step's batch, and the
    validation's clouds times its passes."""
    return r.traced_calls * r.clouds_per_call + r.extra.get("traced_val_clouds", 0)


def train_mfu_pct(r):
    """Model FLOPs of the traced epoch (a step three forwards of its batch, a
    validation cloud one forward) over its wall time, against the float32 peak."""
    if r.trace is None or not r.traced_calls:
        return None
    n = r.config["n_points"]
    flops = (model_flops.train_step(r.config, n, r.clouds_per_call) * r.traced_calls
             + model_flops.forward(r.config, n) * r.extra.get("traced_val_clouds", 0))
    return flops / r.trace.window_s / peaks.F32_OPS_PER_S * 100.0
