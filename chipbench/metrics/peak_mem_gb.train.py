"""The card's peak allocated memory in a training window, in GB:
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
the window's start."""


def read(r):
    if r.get("kind") != "train":
        return None
    return r["peak_window_bytes"] / 1e9
