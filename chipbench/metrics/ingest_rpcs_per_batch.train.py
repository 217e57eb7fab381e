"""Query RPCs per batch: the store's ``BaseFS`` event ledger counted over
the window, divided by the batches the window fed."""


def read(r):
    if r.get("kind") != "train" or not r["ingest_s"]:
        return None
    return r["ingest_rpcs"] / len(r["ingest_s"])
