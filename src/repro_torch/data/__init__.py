"""Training-data ingestion through the consistency layer (paper §6.3)."""

from repro_torch.data.dlio import PreloadedStore

__all__ = ["PreloadedStore", "TokenPipeline", "synthetic_batch"]


def __getattr__(name):
    # TokenPipeline/synthetic_batch pull in torch: load them lazily so
    # data-plane code that only needs PreloadedStore stays framework-free.
    if name in ("TokenPipeline", "synthetic_batch"):
        from repro_torch.data import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
