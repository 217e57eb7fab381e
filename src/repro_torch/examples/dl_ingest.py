"""The paper's §6.3 case study as a runnable example: distributed-DL
sample ingestion under commit vs. session consistency, priced by the DES.

    PYTHONPATH=src python -m repro_torch.examples.dl_ingest [--hosts 8] [--epochs 2]

Ported from the reference's ``examples/dl_ingest.py``.  Every sample is
byte-verified on read; bandwidths come from the discrete-event model
replaying the real RPC/transfer ledger.  The ingest itself runs on the
host; ``--device`` is resolved as in the other twins, so ``--device cuda``
without a card raises.
"""

from __future__ import annotations

import argparse

from repro_torch.core.costmodel import CostModel
from repro_torch.data.dlio import PreloadedStore
from repro_torch.launch.serve import resolve_device


def run(model: str, hosts: int, per_host: int, epochs: int) -> None:
    store = PreloadedStore(model, num_hosts=hosts,
                           samples_per_host=per_host,
                           sample_bytes=116 * 1024, procs_per_host=4)
    store.preload()
    stats = [store.run_epoch(e) for e in range(epochs)]
    phases = CostModel().replay(store.fs.ledger)
    print(f"\n== {model} consistency ==")
    for e, st in enumerate(stats):
        ph = [p for p in phases if p.name == f"epoch_{e}"][0]
        print(f"  epoch {e}: {st.samples_read} samples "
              f"({st.local_reads} local / {st.remote_reads} remote), "
              f"{st.queries} query RPCs, "
              f"modeled bandwidth {ph.io_bandwidth/1e9:.2f} GB/s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=8)
    ap.add_argument("--samples-per-host", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    for model in ("commit", "session"):
        run(model, args.hosts, args.samples_per_host, args.epochs)
    print("\nsession amortizes one query per (reader, shard) per epoch;"
          "\ncommit pays one query per sample — the paper's Fig. 6 gap.")


if __name__ == "__main__":
    main()
