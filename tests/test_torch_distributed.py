"""The port's multi-rank substrate (``repro_torch.runtime``) on a gloo world
of 8 CPU ranks, counterpart of ``tests/test_distributed.py``'s 8 virtual
devices: ``make_sharded_mp`` (all-gather and all-to-all strategies) on
JAX's data against the dense reference (1e-5), ``compressed_psum``
(relative error < 0.02, JAX's int8 bound), ``shard_map`` and
``logical_constraint`` on a (4, 2) mesh.

The world is one set of subprocesses, started once for the module (each
rank a process; rendezvous through a file under the test's temporary
directory, never a fixed port; a 180 s limit); every test reads its own
tagged line of the ranks' output.  :func:`run_world` also starts the
worlds of ``test_torch_checkpoint.py`` and ``test_torch_gnn_sharded.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
WORLD_TIMEOUT_S = 180


def run_world(script: str, world: int, workdir: Path, args=(),
              timeout: float = WORLD_TIMEOUT_S) -> list:
    """Run ``script`` as ``world`` ranks (argv: rank, world, init method,
    ``args``), one process each, one CPU thread each; -> every rank's
    stdout.  Fails with the ranks' output if one exits non-zero or the
    world outlives ``timeout`` (every rank is killed then)."""
    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / "world_script.py"
    path.write_text(script)
    init = "file://" + str(workdir / "rendezvous")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-W", "ignore", str(path), str(r), str(world), init,
         *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT)) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode, o[0][-1500:], o[1][-3000:])
           for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode != 0]
    assert not bad, bad
    return [o[0] for o in outs]


WORLD_PREAMBLE = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
"""

_SUBSTRATE = WORLD_PREAMBLE + r"""
from repro_torch import runtime as RT
from repro_torch.optim.compression import compressed_psum

mesh = RT.make_mesh((8,), ("graph",), device="cpu")
P_total, n_local, f = 8, 4, 6
N = P_total * n_local
rng = np.random.default_rng(0)
E = 64
src = rng.integers(0, N, E).astype(np.int32)
dst = rng.integers(0, N, E).astype(np.int32)
x = rng.normal(size=(N, f)).astype(np.float32)
mask = np.ones((E,), bool)

phi = lambda m: m * 2.0

ref = np.zeros((N, f), np.float32)
for s_, d_ in zip(src, dst):
    ref[d_] += 2.0 * x[s_]

def report(tag, got, want, tol):
    err = float(np.abs(got - want).max())
    ok = np.allclose(got, want, rtol=tol, atol=tol)
    print(f"{tag} {'OK' if ok else 'BAD'} {err:.3e}", flush=True)

t = torch.from_numpy
fn = RT.make_sharded_mp(mesh, "graph", phi, strategy="allgather")
out = fn(t(x), t(src), t(dst), t(mask))
report("ALLGATHER", out.numpy(), ref, 1e-5)

order = np.argsort(src // n_local, kind="stable")
src_s, dst_s = src[order], dst[order]
counts = np.bincount(src_s // n_local, minlength=P_total)
per = counts.max()
src_p = np.zeros((P_total, per), np.int32)
dst_p = np.zeros((P_total, per), np.int32)
msk_p = np.zeros((P_total, per), bool)
for p in range(P_total):
    e_p = np.where(src_s // n_local == p)[0]
    src_p[p, :len(e_p)] = src_s[e_p] % n_local
    dst_p[p, :len(e_p)] = dst_s[e_p]
    msk_p[p, :len(e_p)] = True
fn2 = RT.make_sharded_mp(mesh, "graph", phi, strategy="alltoall", capacity=per * 2)
out2 = fn2(t(x), t(src_p.reshape(-1)), t(dst_p.reshape(-1)), t(msk_p.reshape(-1)))
report("ALLTOALL", out2.numpy(), ref, 1e-5)

# capacity 1 drops: every rank pair carries at most one message
out3 = RT.make_sharded_mp(mesh, "graph", phi, strategy="alltoall", capacity=1)(
    t(x), t(src_p.reshape(-1)), t(dst_p.reshape(-1)), t(msk_p.reshape(-1)))
print("ALLTOALL_DROPS", "OK" if not np.allclose(out3.numpy(), ref) else "BAD", flush=True)

g = rng.normal(size=(8, 128)).astype(np.float32)
want = g.sum(axis=0)
got = compressed_psum(t(g[rank])).numpy()
rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
print(f"CPSUM {'OK' if rel < 0.02 else 'BAD'} {rel:.3e}", flush=True)

# shard_map over a (4, 2) mesh: blocks cut, body run, blocks gathered
mesh2 = RT.make_debug_mesh(4, 2, device="cpu")
spec = RT.PartitionSpec("data", "model")
a = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
seen = []
def body(blk):
    seen.append(tuple(blk.shape))
    return blk * 3.0
b = RT.shard_map(body, mesh2, in_specs=spec, out_specs=spec)(a)
ok = torch.equal(b, a * 3.0) and seen == [(2, 3)]
print("SHARD_MAP", "OK" if ok else "BAD", flush=True)

# logical_constraint: the rank's block under the active mesh and rules
with RT.use_mesh(mesh2), RT.active_rules(RT.fsdp_rules(mesh2, 8)):
    blk = RT.logical_constraint(a, ("batch", None))
    whole = RT.logical_constraint(a[:3], ("batch", None))  # 3 rows divide nothing
r = rank
ok = torch.equal(blk, a[r:r + 1]) and whole.shape == (3, 6)
print("LOGICAL_CONSTRAINT", "OK" if ok else "BAD", flush=True)
dist.barrier()
dist.destroy_process_group()
"""

TAGS = ("ALLGATHER", "ALLTOALL", "ALLTOALL_DROPS", "CPSUM", "SHARD_MAP",
        "LOGICAL_CONSTRAINT")


@pytest.fixture(scope="module")
def substrate_world(tmp_path_factory):
    return run_world(_SUBSTRATE, 8, tmp_path_factory.mktemp("substrate"))


@pytest.mark.parametrize("tag", TAGS)
def test_substrate_on_eight_ranks(substrate_world, tag):
    for rank, out in enumerate(substrate_world):
        lines = [ln for ln in out.splitlines() if ln.split()[:1] == [tag]]
        assert len(lines) == 1, (rank, out)
        assert lines[0].split()[1] == "OK", (rank, lines[0])


@pytest.mark.parametrize("strategy", ["allgather", "alltoall"])
def test_sharded_mp_on_one_rank(strategy):
    """A 1-rank mesh needs no process group: both bodies run their
    collectives as no-ops and match the dense reference."""
    import torch

    from repro_torch import runtime as RT

    rng = np.random.default_rng(0)
    n, e, f = 12, 30, 5
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    mask = rng.random(e) < 0.8
    ref = np.zeros((n, f), np.float32)
    for s_, d_, m_ in zip(src, dst, mask):
        ref[d_] += 2.0 * x[s_] * m_
    mesh = RT.make_mesh((1,), ("graph",), device="cpu")
    fn = RT.make_sharded_mp(mesh, "graph", lambda m: m * 2.0, strategy=strategy,
                            capacity=e)
    t = torch.from_numpy
    out = fn(t(x), t(src), t(dst), t(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
