"""Runnable twins of the reference's examples, on the port.

* :mod:`repro_torch.examples.dl_ingest`        — §6.3 DL ingest, commit vs. session
* :mod:`repro_torch.examples.train_checkpoint` — ingest -> train -> checkpoint,
  a host failure and an elastic restart
* :mod:`repro_torch.examples.quickstart`       — train, generate, checkpoint

Each runs as ``python -m repro_torch.examples.<name>`` with the reference
example's flags and defaults, plus ``--device`` (the card unless the caller
asks for the CPU).
"""
