"""Host milliseconds per batch of the training feed (``TokenPipeline``
over the ``PreloadedStore`` and its consistency layer), the benchmark's
clock around each ``next()`` of the feed in the window."""


def read(r):
    if r.get("kind") != "train" or not r["ingest_s"]:
        return None
    return 1e3 * sum(r["ingest_s"]) / len(r["ingest_s"])
