"""The training steps' operations (forward and backward, counted on the
reference) done in the window, over its seconds at the 3xTF32 peak, %."""

from benchmark.layer_metrics._common import mfu_pct


def read(rec):
    return mfu_pct(rec, "step_flops", "steps")
