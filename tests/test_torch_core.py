"""The port's copy of the file-system stack (``repro_torch.core``) against
the reference's (``repro.core``).

* ``tests/test_ledger_golden.py`` and ``tests/test_basefs.py`` run here
  against the port: their source is loaded with ``repro.core`` read as
  ``repro_torch.core``, so every case (and the golden ledger) is theirs.
* Seeded programs of open / write / seek / read / publish (commit, session
  close, file sync) / session open / flush / detach / phase markers run
  through both packages under each consistency model and two deployments:
  every ``Event`` field, every read's bytes and ``CostModel().replay``'s
  phases (scalar and vector engines) must be equal.
"""

import dataclasses
import enum
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import repro.core.basefs as ref_basefs
import repro.core.consistency as ref_consistency
import repro.core.costmodel as ref_costmodel
import repro_torch.core.basefs as port_basefs
import repro_torch.core.consistency as port_consistency
import repro_torch.core.costmodel as port_costmodel

TESTS = Path(__file__).resolve().parent
MODELS = ("posix", "commit", "session", "mpiio")


def _against_port(filename: str, renames=(("repro.core", "repro_torch.core"),)):
    """The test module ``filename`` with each ``(old, new)`` of ``renames``
    replaced in its source, in order: module prefixes (by default its
    ``repro.core`` imports read as ``repro_torch.core``) and, where a test
    names the reference's files, their paths.  No ``repro.`` import may be
    left."""
    src = (TESTS / filename).read_text()
    for old, new in renames:
        src = src.replace(old, new)
    assert "from repro." not in src and "import repro." not in src
    spec = importlib.util.spec_from_loader(f"port_{Path(filename).stem}",
                                           loader=None)
    mod = importlib.util.module_from_spec(spec)
    exec(compile(src, str(TESTS / filename), "exec"), mod.__dict__)
    return mod


_golden = _against_port("test_ledger_golden.py")
_basefs = _against_port("test_basefs.py")

# Every case of tests/test_basefs.py, on the port's modules.
TestBaseFSPrimitives = _basefs.TestBaseFSPrimitives
TestPosixFS = _basefs.TestPosixFS
TestCommitFS = _basefs.TestCommitFS
TestSessionFS = _basefs.TestSessionFS
TestMPIIOFS = _basefs.TestMPIIOFS
TestMakeFS = _basefs.TestMakeFS
# tests/test_ledger_golden.py's two cases, on the port's modules.
test_golden_ledger_through_port = \
    _golden.test_default_deployment_matches_pre_sendqueue_ledger
test_golden_deployment_has_no_sendqueue_artifacts = \
    _golden.test_default_deployment_has_no_sendqueue_artifacts


def test_golden_run_uses_the_port():
    fs = _golden._golden_run()
    assert isinstance(fs, port_basefs.BaseFS)
    assert len(fs.ledger.events) == len(_golden.GOLDEN)


def _plain(x):
    """Enums by value, containers element-wise: comparable across packages."""
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def events(fs):
    return [tuple(_plain(getattr(e, f.name)) for f in dataclasses.fields(e))
            for e in fs.ledger.events]


def phases(result):
    return ([tuple(_plain(getattr(p, f.name)) for f in dataclasses.fields(p))
             for p in result], result.engine, result.fallback_reason)


def _program(basefs, consistency, model: str, seed: int, deployment: dict):
    """A seeded program of 160 operations by 5 clients on 3 files; returns
    (the deployment, the bytes of every read and the message of every
    ``BFSError``: a read of data its owner has since detached is one)."""
    rng = np.random.default_rng(seed)
    fs = basefs.BaseFS(**deployment)
    layer = consistency.make_fs(model, fs)
    handles, reads = {}, []

    def handle(client, path):
        if (client, path) not in handles:
            fh = (layer.file_open(client, path, node=client % 3)
                  if model == "mpiio" else
                  layer.open(client, path, node=client % 3))
            if model == "session":
                layer.session_open(fh)
            handles[client, path] = fh
        return handles[client, path]

    ops = ("write", "write", "read", "read", "publish", "refresh", "flush",
           "detach", "stat", "phase")
    for i in range(160):
        fh = handle(int(rng.integers(5)), f"/p/f{int(rng.integers(3))}")
        op = ops[int(rng.integers(len(ops)))]
        try:
            _step(fs, layer, model, fh, op, rng, reads, i)
        except basefs.BFSError as e:
            reads.append(str(e))
    fs.drain()
    return fs, reads


def _step(fs, layer, model, fh, op, rng, reads, i):
    """One operation of :func:`_program`."""
    if op == "write":
        layer.seek(fh, int(rng.integers(0, 4096)))
        n = int(rng.integers(1, 700))
        layer.write(fh, rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    elif op == "read":
        layer.seek(fh, int(rng.integers(0, 4096)))
        reads.append(bytes(layer.read(fh, int(rng.integers(1, 900)))))
    elif op == "publish":
        {"commit": lambda: layer.commit(fh),
         "session": lambda: layer.session_close(fh),
         "mpiio": lambda: layer.file_sync(fh),
         "posix": lambda: None}[model]()
    elif op == "refresh":
        if model == "session":
            layer.session_open(fh)
        elif model == "mpiio":
            layer.file_sync(fh)
    elif op == "flush":
        fs.bfs_flush_file(fh.client, fh.bfs_handle)
    elif op == "detach":
        fs.bfs_detach_file(fh.client, fh.bfs_handle)
    elif op == "stat":
        reads.append(layer.stat_size(fh))
    else:
        fs.ledger.mark_phase(f"phase{i}")


DEPLOYMENTS = {"default": {}, "sharded-batched": {"num_shards": 2, "batch": 4}}


@pytest.mark.parametrize("deployment", sorted(DEPLOYMENTS))
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("model", MODELS)
def test_programs_match_the_reference(model, seed, deployment):
    ref_fs, ref_reads = _program(ref_basefs, ref_consistency, model, seed,
                                 DEPLOYMENTS[deployment])
    port_fs, port_reads = _program(port_basefs, port_consistency, model, seed,
                                   DEPLOYMENTS[deployment])
    assert port_reads == ref_reads
    assert events(port_fs) == events(ref_fs)
    assert len(events(ref_fs)) > 100
    for engine in ("scalar", "vector"):
        want = ref_costmodel.CostModel().replay(ref_fs.ledger, engine=engine)
        got = port_costmodel.CostModel().replay(port_fs.ledger, engine=engine)
        assert phases(got) == phases(want), engine
