"""The training step's share of the card's bf16 peak: the model FLOPs of
the window's steps (``counts.train_step_flops``, nothing recomputed) over
the window's wall time, over 989 TFLOP/s."""

from chipbench import counts


def read(r):
    if r.get("kind") != "train" or not r["steps"]:
        return None
    return 100 * r["model_flops"] / r["window_s"] / counts.PEAK_FLOPS
