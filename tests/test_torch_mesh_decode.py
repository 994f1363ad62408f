"""Decode on a mesh: MLA's absorbed decode and a cache cut on its positions.

``models/layers.py`` runs a decode step on DTensor caches on each rank's
block under ``local_map``: GQA (``_decode_sharded``) and MLA
(``_mla_decode_sharded``).  A cache cut on batch or heads attends on the
rank's block as one rank would; a cache cut on its positions (``Shard(1)``:
``batch_rules`` with a batch smaller than the data axis, the 500k cells)
writes slot t only on the rank whose block holds it, attends on its block
with the keys' global positions, and the ranks combine their partial
softmaxes (an all-reduce MAX of the row maxima, an all-reduce SUM of the
sums and products, fp32).

Held against the one-rank step on real gloo worlds of CPU ranks (logits
within 1e-5 of their largest, caches within 1e-6), and on fake 2x2 worlds
through the dry-run: no ``out=`` call meets a DTensor and no all-gather
moves the cache's positions.
"""
from __future__ import annotations

import json

import pytest

from test_torch_distributed import WORLD_PREAMBLE, run_world
from test_torch_dryrun import _child

LOGITS_BOUND = 1e-5  # max |mesh - one rank| / max |one rank|
CACHE_BOUND = 1e-6

_STEP = r"""
import json
from torch.distributed.tensor import DTensor
from repro_torch import runtime as RT
from repro_torch.configs import get_reduced
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import partitioning as SH
from repro_torch.train.loop import mesh_scope

arch, shape, tkind = sys.argv[4], tuple(int(v) for v in sys.argv[5].split("x")), sys.argv[9]
batch, prompt_len, cache_len = int(sys.argv[6]), int(sys.argv[7]), int(sys.argv[8])
inputs = sys.argv[10]
cfg = get_reduced(arch, dtype="float32")
params = torch.load(inputs + "/params.pt")
data = np.load(inputs + "/inputs.npz")
prompt, tok = torch.from_numpy(data["prompt"]), torch.from_numpy(data["tok"])
cache, _, t0 = lm.prefill(params, {"tokens": prompt}, cfg, cache_len)
t = torch.tensor(t0) if tkind == "tensor" else t0
want_cache = adamw.tree_map(lambda x: x.clone(), cache)
want, _ = lm.decode_step(params, want_cache, tok, t, cfg)
mesh = RT.make_mesh(shape, ("data", "model"), device="cpu")
rules = SH.batch_rules(mesh, batch)
put = lambda x, axes: SH.place(x, SH.resolve_spec(axes, tuple(x.shape), mesh, rules), mesh)
placed = SH.place_tree(params, lm.param_axes(cfg), mesh, rules)
pc = SH._map_with_axes(lambda x, axes: put(x.clone(), axes), cache, lm.cache_axes(cfg))
with mesh_scope(mesh, rules):
    got, got_cache = lm.decode_step(placed, pc, put(tok, ("batch", None)), t, cfg)
got = got.full_tensor() if isinstance(got, DTensor) else got
whole = lambda x: x.full_tensor() if isinstance(x, DTensor) else x
res = dict(finite=bool(torch.isfinite(got).all()),
           placements=sorted({str(a.placements) for a in adamw.leaves(got_cache)
                              if isinstance(a, DTensor)}))
# each layer position's cache entries in sorted key order, as JAX's (the
# gathers on every rank)
keys = [f"{i}/{k}" for i, d in enumerate(want_cache) for k in sorted(d)]
leaves = lambda c: [whole(d[k]).numpy() for d in c for k in sorted(d)]
mesh_leaves, one_leaves = leaves(got_cache), leaves(want_cache)
if rank == 0:
    np.savez(inputs + "/steps.npz", mesh=got.numpy(), one=want.numpy(),
             **{f"mesh:{k}": v for k, v in zip(keys, mesh_leaves)},
             **{f"one:{k}": v for k, v in zip(keys, one_leaves)})
    print(json.dumps(res))
"""

# (arch, mesh, batch, prompt, cache, position as) -> the stacked caches'
# placements (a mesh dim of size 1 keeps its Shard).  MiniCPM3 (MLA): its
# latent caches (layers, B, S, kvr) cut on batch over data (2x1), whole on
# model with q's heads and w_uk / w_uv cut there (1x2), or cut on positions
# (batch 1); a GQA cache (layers, B, S, Hkv, D) cut on positions and kv
# heads.  Batch 1 cuts every cache on
# its positions: Mixtral's window of 8 (reduced) over a cache of 32 in 4
# blocks of 8 leaves rank 0's block wholly masked by the window and rank
# 3's by causality; slot 16 is the first of rank 1's block on 2 ranks.
STEPS = {
    ("minicpm3-4b", "1x2", 4, 8, 16, "int"): "(Shard(dim=1), Replicate())",
    ("minicpm3-4b", "2x1", 4, 8, 16, "int"): "(Shard(dim=1), Replicate())",
    ("minicpm3-4b", "2x1", 1, 16, 32, "tensor"): "(Shard(dim=2), Replicate())",
    ("mixtral-8x7b", "2x1", 1, 16, 32, "tensor"): "(Shard(dim=2), Shard(dim=3))",
    ("mixtral-8x7b", "4x1", 1, 16, 32, "int"): "(Shard(dim=2), Shard(dim=3))",
    ("mixtral-8x7b", "2x2", 1, 16, 32, "tensor"): "(Shard(dim=2), Shard(dim=3))",
    ("gemma3-12b", "2x1", 1, 13, 32, "int"): "(Shard(dim=2), Shard(dim=3))",
}
# the port's one-rank and mesh steps against JAX's decode_step on the same
# converted weights, prompt and position: test_torch_lm.py's fp32 bound
JAX_TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_step(arch, batch, prompt_len, cache_len, out):
    """JAX's init_params(PRNGKey(0)) for the reduced fp32 config, converted
    to the port's tree and saved with a prompt and a token drawn from a
    seed (``out``); -> JAX's prefill then decode_step there: (logits,
    {"<layer position>/<key>": cache leaf})."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro import params as JP
    from repro.configs import get_reduced as jget_reduced
    from repro.models import lm as JLM
    from repro_torch.convert import from_jax_lm_params

    cfg = jget_reduced(arch, dtype="float32")
    jp = jax.jit(lambda key: JP.values(JLM.init_params(key, cfg)))(jax.random.PRNGKey(0))
    torch.save(from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jp)), out / "params.pt")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    tok = rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32)
    np.savez(out / "inputs.npz", prompt=prompt, tok=tok)
    cache, _, t0 = JLM.prefill(jp, {"tokens": jnp.asarray(prompt)}, cfg, cache_len)
    logits, cache = JLM.decode_step(jp, cache, jnp.asarray(tok), t0, cfg)
    return np.asarray(logits), {f"{i}/{k}": np.asarray(v) for i, d in enumerate(cache)
                                for k, v in sorted(d.items())}


@pytest.mark.parametrize("case", list(STEPS), ids=lambda c: "-".join(map(str, c)))
def test_decode_step_on_a_gloo_world_matches_one_rank(case, tmp_path):
    """One decode step of a reduced model (fp32) on a gloo world of CPU
    ranks against the one-rank step on the same cache: logits within 1e-5
    of their largest, finite, and every cache leaf after the step within
    1e-6 of its largest (slot t written on the rank that holds it).  Both
    steps are also held against JAX's prefill and decode_step on the same
    converted weights (logits and every cache leaf, ``JAX_TOL``)."""
    import numpy as np

    arch, shape, batch, prompt, cache, tkind = case
    world = eval(shape.replace("x", "*"))
    jax_logits, jax_cache = _jax_step(arch, batch, prompt, cache, tmp_path)
    out = run_world(WORLD_PREAMBLE + _STEP, world, tmp_path,
                    args=(arch, shape, batch, prompt, cache, tkind, tmp_path))
    res = json.loads(out[0].strip().splitlines()[-1])
    assert res["finite"], res
    assert STEPS[case] in res["placements"], res
    steps = np.load(tmp_path / "steps.npz")
    got, want = steps["mesh"], steps["one"]
    assert np.abs(got - want).max() <= LOGITS_BOUND * np.abs(want).max()
    assert sorted(k.split(":", 1)[1] for k in steps.files if k.startswith("one:")) \
        == sorted(jax_cache)
    for key, leaf in jax_cache.items():
        mesh_leaf, one_leaf = steps[f"mesh:{key}"], steps[f"one:{key}"]
        assert np.abs(mesh_leaf - one_leaf).max() <= CACHE_BOUND * max(
            np.abs(one_leaf).max(), 1e-30), key
        for name, step in (("one rank", one_leaf), ("mesh", mesh_leaf)):
            np.testing.assert_allclose(step, leaf, **JAX_TOL, err_msg=f"{name} {key}")
    for name, step in (("one rank", want), ("mesh", got)):
        np.testing.assert_allclose(step, jax_logits, **JAX_TOL, err_msg=name)


_BLOCKS = r"""
import json
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch import runtime as RT
from repro_torch.models import layers as L

mesh = RT.make_mesh((world,), ("data",), device="cpu").device_mesh
window, softcap, t, tkind = int(sys.argv[4]), float(sys.argv[5]), int(sys.argv[6]), sys.argv[7]
b, s, h, hkv, d = 2, int(sys.argv[8]), 4, 2, 8
rng = np.random.default_rng(5)
q, k, v = (torch.from_numpy(rng.normal(size=(b, 1, n, d)).astype(np.float32))
           for n in (h, hkv, hkv))
kc, vc = (torch.from_numpy(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
          for _ in range(2))
want_k, want_v = kc.clone(), vc.clone()
L._cache_update(want_k, k, t)
L._cache_update(want_v, v, t)
want = L.decode_attention(q, want_k, want_v, t, window=window, softcap=softcap)
rep = lambda x: DTensor.from_local(x, mesh, [Replicate()])
cut = lambda x: distribute_tensor(x.clone(), mesh, [Shard(1)])  # DTensor's chunks
dk, dv = cut(kc), cut(vc)
pos = torch.tensor(t) if tkind == "tensor" else t
got = L._decode_sharded(rep(q), rep(k), rep(v), dk, dv, pos, window, softcap)
got = got.full_tensor()
res = dict(err=float((got - want).abs().max() / want.abs().max()),
           finite=bool(torch.isfinite(got).all()),
           k=bool(torch.equal(dk.full_tensor(), want_k)),
           v=bool(torch.equal(dv.full_tensor(), want_v)))
if rank == 0:
    print(json.dumps(res))
"""

# (world, window, softcap, t, position as, cache positions): blocks of 8
# positions; a window of 4 ending at t 11 masks block 0 wholly (and blocks
# past t by causality); softcap 5 bends every logit; t 8 is a block's first
# slot.  A cut that does not divide the cache gives DTensor's chunks of
# ceil(S / n): 29 on 4 ranks 8 / 8 / 8 / 5, 10 on 3 ranks 4 / 4 / 2, and 5
# on 4 ranks 2 / 2 / 1 / 0 (the last rank holds no slot)
BLOCKS = [(2, 4, 5.0, 11, "tensor", 16), (2, 0, 0.0, 8, "int", 16),
          (4, 4, 5.0, 17, "int", 32), (4, 0, 5.0, 31, "tensor", 32),
          (4, 4, 5.0, 27, "tensor", 29), (3, 0, 5.0, 9, "int", 10), (4, 0, 0.0, 4, "int", 5)]


def _block_id(case) -> str:
    """The case's id, its cache length shown only where the cut does not
    give blocks of 8."""
    return "-".join(map(str, case[:5])) + ("" if case[5] == 8 * case[0] else f"-{case[5]}")


@pytest.mark.parametrize("world,window,softcap,t,tkind,s", BLOCKS,
                         ids=[_block_id(c) for c in BLOCKS])
def test_sequence_cut_decode_attention_matches_whole(world, window, softcap, t, tkind, s,
                                                     tmp_path):
    """``_decode_sharded`` on caches cut on their positions over a 1-D
    world against ``decode_attention`` on the whole caches: the write lands
    in the block that holds t (every cache bit for bit the one-rank
    write), the output within 1e-5 of its largest and finite where a
    rank's block is wholly masked by the window or by causality, or when
    the cut does not divide the cache (a block's start from DTensor's
    chunk rule; a rank with no slot adds nothing)."""
    out = run_world(WORLD_PREAMBLE + _BLOCKS, world, tmp_path,
                    args=(window, softcap, t, tkind, s))
    res = json.loads(out[0].strip().splitlines()[-1])
    assert res["finite"] and res["k"] and res["v"], res
    assert res["err"] <= LOGITS_BOUND, res


_FAKE = r"""
import json, logging, sys
logging.disable(logging.WARNING)
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun as D
from repro_torch.models.config import ShapeConfig


class OutOnDTensor(TorchFunctionMode):
    # every torch call given out= where an argument or the out is a DTensor
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = kwargs.get("out")
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        if out is not None and any(isinstance(t, DTensor) for t in [*args, *outs]):
            self.calls.append(str(func))
        return func(*args, **kwargs)


arch, batch = sys.argv[1], int(sys.argv[2])
shape = ShapeConfig(f"decode_b{batch}_c256", 256, batch, "decode")
mode = OutOnDTensor()
with mode:
    rec = D.run_cell(arch, shape, False, mesh=(2, 2), config_fn=get_reduced)
print(json.dumps(dict(error=rec.get("error"), colls=rec["collectives"], out_calls=mode.calls,
                      flops=rec["flops_per_device"])))
"""


@pytest.mark.parametrize("arch,batch", [("minicpm3-4b", 8), ("minicpm3-4b", 1),
                                        ("mixtral-8x7b", 1), ("gemma3-12b", 1),
                                        ("jamba-v0.1-52b", 1)])
def test_decode_cell_on_a_fake_2x2_world_gathers_no_cache(arch, batch):
    """A reduced decode cell (cache 256) on a fake 2x2 world: MLA cut on
    batch (B 8) and every family whose batch 1 cuts the caches on their
    positions.  The step runs, no ``out=`` call meets a DTensor, no
    all-gather's shape holds the cache's 256 positions, and the positions'
    softmax is all-reduced (a MAX and a SUM a layer) where they are cut."""
    c = _child(_FAKE, arch, str(batch))
    assert c["error"] is None and c["out_calls"] == [], c["out_calls"]
    gathers = [r["shape"] for r in c["colls"] if r["op"] == "all-gather"]
    assert not any(256 in shape for shape in gathers), gathers
    assert c["flops"] > 0
    if batch == 1:
        assert any(r["op"] == "all-reduce" for r in c["colls"]), c["colls"]
