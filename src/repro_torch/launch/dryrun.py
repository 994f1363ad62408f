"""Multi-pod dry-run (port of ``repro.launch.dryrun``): run one step of
every (architecture x shape x mesh) cell once, on fake tensors in a fake
world of 256 (single pod, 16x16) or 512 (multi-pod, 2x16x16) ranks, and
record a rank's memory, FLOPs, bytes and the collectives it issues.

Usage:
  python -m repro_torch.launch.dryrun --arch starcoder2-15b --shape train_4k
  python -m repro_torch.launch.dryrun --all                 # all 40 cells, both meshes
  python -m repro_torch.launch.dryrun --all --mesh single   # the roofline table's mesh

How a cell "lowers".  The process joins a fake process group
(``torch.testing._internal.distributed.fake_pg``: rank 0 of a world of
256 or 512, every collective a no-op), builds
``runtime.mesh.make_production_mesh(device="cpu")`` on it and runs the
port's real step once under a ``FakeTensorMode`` (shapes, dtypes and
placements, no values, no memory):

  * train: ``train.loop.make_train_step`` (loss, remat, gradients, AdamW
    on the ``place_tree`` placements; ZeRO-1 moments under ``+zero1``);
  * prefill: ``models.lm.prefill``; decode: ``models.lm.decode_step``.

The kernel mode is pinned to ``reference``: JAX's ``models/`` never call
Pallas, so what is counted is the plain attention, as in JAX; no kernel is
built and no card is touched.  While the step runs, ``roofline``'s
counters see each rank-local op (DTensor's sharding propagation at global
shapes excluded): FLOPs, bytes accessed, the collectives, the peak of live
storage.  DTensor's own bookkeeping stays on real tensors where it reads
values (a strided shard's offsets), and a Shard -> Shard redistribution
issues the card's all-to-all, not the all-gather DTensor falls back to on
a CPU mesh (``_dtensor_as_on_cards``).

Records keep JAX's keys, with these differences: ``trace_s`` (the step's
one run) in place of ``lower_s`` / ``compile_s``; ``memory.
generated_code_bytes`` 0 (nothing is compiled: eager torch runs the
kernels of its library); ``collectives_corrected`` equal to
``collectives`` (fake tensors keep bf16: no normalization to undo);
``hbm_estimate.fits_80gb`` (the card's capacity) in place of
``fits_16gb``.  Results go under ``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import time
import traceback

import torch

from repro_torch import roofline as R
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs as SPECS
from repro_torch.models import lm
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.optim import adamw
from repro_torch.runtime import compat as RTC
from repro_torch.runtime import partitioning as SH
from repro_torch.runtime.mesh import PRODUCTION_SHAPES, make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "../../../experiments/dryrun_torch")
CAPACITY_KEY = "fits_80gb"

# JAX's attention / loss chunks per shape (config fields the port keeps)
_ATTN_CHUNK = {"train_4k": 2048, "prefill_32k": 8192, "decode_32k": 8192, "long_500k": 8192}
_LOSS_CHUNK = {"train_4k": 512}


# long_500k runs only for sub-quadratic archs; whisper's decoder context is
# 448 by design, so a 500k cache is not meaningful.
def cell_skip_reason(arch: str, cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k":
        if arch == "whisper-base":
            return "whisper decoder context is 448; 500k KV cache not meaningful"
        if not cfg.is_sub_quadratic:
            return "pure full-attention arch: long_500k skipped per brief"
    return None


def _cache_len(shape: ShapeConfig) -> int:
    return shape.seq_len


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------


def fake_world(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (once a
    process; a real group cannot share the process)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks is up, "
                               f"not {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


_FAKE_MODES: list = []


def fake_mode():
    """The process's one ``FakeTensorMode``: the models cache small tables
    (RoPE's) across calls, and tensors of two fake modes cannot meet."""
    if not _FAKE_MODES:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _FAKE_MODES.append(FakeTensorMode())
    return _FAKE_MODES[0]


def _run_real(fn):
    """``fn`` with any fake mode set aside while it runs: DTensor's
    bookkeeping computes integer offsets from small tensors and reads them
    back, which a fake tensor cannot give."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def wrapped(*a, **k):
        with unset_fake_temporarily():
            return fn(*a, **k)

    return wrapped


@contextlib.contextmanager
def _dtensor_as_on_cards():
    """DTensor as it runs on a mesh of cards, for the dry-run's fake tensors
    on a CPU mesh: a strided shard's size and offset computed on real
    tensors, and Shard -> Shard issued as the all-to-all op (its fake
    implementation), where a CPU mesh would all-gather and chunk.  Its
    redistribution warnings are silenced."""
    from torch.distributed.tensor import _collective_utils as CU
    from torch.distributed.tensor import placement_types as PTY

    undo = []

    def patch(owner, name, value):
        undo.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    strided = getattr(PTY, "_StridedShard", None)
    for name in ("local_shard_size_and_offset", "_local_shard_size_and_offset"):
        if strided is not None and name in strided.__dict__:
            f = strided.__dict__[name]
            raw = f.__func__ if isinstance(f, (staticmethod, classmethod)) else f
            w = _run_real(raw)
            patch(strided, name, type(f)(w) if isinstance(f, (staticmethod, classmethod)) else w)
    if hasattr(torch.ops, "_dtensor") and hasattr(CU, "shard_dim_alltoall"):
        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            return torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

        for owner in (CU, PTY):
            if "shard_dim_alltoall" in owner.__dict__:
                patch(owner, "shard_dim_alltoall", shard_dim_alltoall)
    log = logging.getLogger("torch.distributed.tensor")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        yield
    finally:
        log.setLevel(level)
        for owner, name, value in reversed(undo):
            setattr(owner, name, value)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if adamw.is_dtensor(t) else t


def local_bytes(tree) -> int:
    """A rank's bytes of a tree of tensors (DTensor leaves: its block)."""
    return sum(_local(t).numel() * _local(t).element_size() for t in adamw.leaves(tree)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# the cell's step
# ---------------------------------------------------------------------------


def _place(t: torch.Tensor, axes, mesh, rules) -> torch.Tensor:
    return SH.place(t, SH.resolve_spec(axes, tuple(t.shape), mesh, rules), mesh)


def build_lowerable(cfg: ModelConfig, shape: ShapeConfig, mesh, rules, zero1: bool = False):
    """-> (step, args, params_struct): ``step(*args)`` runs the cell's step
    once; ``params_struct`` the parameters at their global shapes.  Called
    under the dry-run's ``FakeTensorMode``: every tensor it makes is fake."""
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    paxes = lm.param_axes(cfg)
    placed = SH.place_tree(params, paxes, mesh, rules)
    b_axes = SPECS.batch_axes(cfg)
    batch = {k: _place(v.empty(), b_axes[k], mesh, rules)
             for k, v in SPECS.batch_specs(cfg, shape).items()}

    if shape.kind == "train":
        from repro_torch.train.loop import make_train_step

        if zero1 and mesh.device_mesh is not None:  # moments also sharded over data
            def moment(leaf, axes):
                spec = SH._leaf_spec(leaf, axes, mesh, rules)
                z = torch.zeros(leaf.shape, dtype=torch.float32)
                return SH.place(z, SH.zero1_spec(spec, tuple(leaf.shape), mesh, "data"), mesh)

            opt = {"m": SH._map_with_axes(moment, params, paxes),
                   "v": SH._map_with_axes(moment, params, paxes),
                   "step": torch.zeros((), dtype=torch.int32)}
        else:
            opt = adamw.init(placed)
        step = make_train_step(cfg, adamw.AdamWConfig())
        return (lambda p, o, b: step(p, o, None, b)), (placed, opt, batch), params

    def new_cache():  # placed by JAX's cache axes
        return SH._map_with_axes(lambda leaf, axes: _place(leaf, axes, mesh, rules),
                                 lm.init_cache(cfg, shape.global_batch, _cache_len(shape)),
                                 lm.cache_axes(cfg))

    if shape.kind == "prefill":
        # the step makes its cache (an output, as JAX's prefill returns it)
        return ((lambda p, b: lm.prefill(p, b, cfg, _cache_len(shape), cache=new_cache())),
                (placed, batch), params)

    cache = new_cache()
    tok_spec, _ = SPECS.decode_token_specs(cfg, shape)
    tokens = _place(tok_spec.empty(), ("batch", None), mesh, rules)
    t = _cache_len(shape) - 1  # the last slot, as an int (JAX's traced t writes there too)
    return ((lambda p, c, tok, tt: lm.decode_step(p, c, tok, tt, cfg)),
            (placed, cache, tokens, t), params)


def _mesh_for(mesh, multi_pod: bool):
    """The cell's mesh: the production mesh of a fake world (``mesh`` None),
    a (data, model) shape on a fake world of its size, or a ``compat.Mesh``
    already built.  A 1-rank mesh needs no world."""
    if isinstance(mesh, RTC.Mesh):
        return mesh
    if mesh is None:
        shape, axes = PRODUCTION_SHAPES[multi_pod]
    else:
        shape, axes = tuple(mesh), ("data", "model")
    if math.prod(shape) == 1:  # one rank: no group, plain tensors
        return RTC.Mesh(dict(zip(axes, shape)), "cpu")
    fake_world(math.prod(shape))
    if mesh is None:
        return make_production_mesh(multi_pod=multi_pod, device="cpu")
    return RTC.make_mesh(shape, axes, device="cpu")


def run_cell(
    arch: str,
    shape_name,
    multi_pod: bool,
    stack_mode: str = "unroll",
    overrides: dict | None = None,
    tag: str = "",
    rules_preset: str = "default",
    mesh=None,
    config_fn=get_config,
) -> dict:
    """One cell's record.  ``shape_name`` names one of ``SHAPES`` or is a
    ``ShapeConfig``; ``mesh`` (default: the production mesh) may be a
    (data, model) shape or a built mesh; ``config_fn`` (default
    ``get_config``) makes the config from the arch and its overrides."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    kw = dict(stack_mode=stack_mode)
    if shape.name in _ATTN_CHUNK:
        kw["attn_chunk"] = _ATTN_CHUNK[shape.name]
    if shape.name in _LOSS_CHUNK:
        kw["loss_chunk"] = _LOSS_CHUNK[shape.name]
    kw.update(overrides or {})
    cfg = config_fn(arch, **kw)
    rec = {
        "arch": arch,
        "shape": shape.name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "multi_pod": multi_pod,
        "kind": shape.kind,
        "stack_mode": cfg.stack_mode,
        "overrides": overrides or {},
        "tag": tag,
    }
    skip = cell_skip_reason(arch, cfg, shape)
    if skip:
        rec["skipped"] = skip
        return rec

    mesh = _mesh_for(mesh, multi_pod)
    if mesh.size != (512 if multi_pod else 256):
        rec["mesh"] = "x".join(str(v) for v in mesh.shape.values())
    if rules_preset.startswith("fsdp"):
        rules = SH.fsdp_rules(mesh, shape.global_batch)
    else:
        rules = SH.batch_rules(mesh, shape.global_batch)
    rec["rules"] = rules_preset

    env = os.environ.get("REPRO_KERNEL_MODE")
    os.environ["REPRO_KERNEL_MODE"] = "reference"
    flops, colls, mem = R.FlopCounter(), R.CollectiveRecorder(), R.StorageTracker()
    try:
        with fake_mode(), _dtensor_as_on_cards():
            fn, args, params_struct = build_lowerable(
                cfg, shape, mesh, rules, zero1=rules_preset.endswith("+zero1"))
            arg_bytes = local_bytes(list(args))
            arg_storages = {_local(t).untyped_storage()._cdata
                            for t in adamw.leaves(list(args)) if isinstance(t, torch.Tensor)}
            grad = contextlib.nullcontext() if shape.kind == "train" else torch.no_grad()
            t0 = time.time()
            with SH.mesh_scope(mesh, rules), grad, flops, colls, mem:
                out = fn(*args)
            rec["trace_s"] = round(time.time() - t0, 2)
            outs = [t for t in adamw.leaves(list(out)) if isinstance(t, torch.Tensor)]
            alias = sum(_local(t).numel() * _local(t).element_size() for t in outs
                        if _local(t).untyped_storage()._cdata in arg_storages)
            new_out = mem.alive_bytes([_local(t) for t in outs])
    finally:
        if env is None:
            os.environ.pop("REPRO_KERNEL_MODE", None)
        else:
            os.environ["REPRO_KERNEL_MODE"] = env

    rec["memory"] = {
        "argument_bytes": int(arg_bytes),
        "output_bytes": int(local_bytes(outs)),
        "temp_bytes": int(max(mem.peak - new_out, 0)),
        "generated_code_bytes": 0,
        "alias_bytes": int(alias),
    }
    rec["generated_code_note"] = ("nothing is compiled: the step runs torch's "
                                  "library kernels eagerly")
    rec["flops_per_device"] = float(flops.flops)
    rec["bytes_per_device"] = float(flops.bytes_accessed)
    rec["collectives"] = colls.records
    rec["collectives_corrected"] = colls.records  # fake tensors keep bf16
    rec["collective_summary"] = R.summarize_collectives(rec["collectives_corrected"])
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = R.model_flops(cfg, params_struct, tokens, shape.kind, lm.param_axes(cfg))
    rec["model_flops_per_device"] = mf / mesh.size
    rec["hbm_estimate"] = estimate_hbm(cfg, shape, mesh, rec, rules)
    rec["roofline"] = R.cell_roofline(rec)
    return rec


def estimate_hbm(cfg: ModelConfig, shape: ShapeConfig, mesh, rec: dict, rules=None) -> dict:
    """Analytic per-device HBM estimate for the 'fits' argument, JAX's
    formula: arguments (params / optimizer / cache, from the record),
    remat residuals (one residual-stream tensor a layer), gradient
    accumulators and the largest transient working set; the capacity is
    the H100's 80 GB (``fits_80gb``; JAX's ``fits_16gb`` is its TPU's)."""
    rules = rules or SH.batch_rules(mesh, shape.global_batch)
    bspec = SH.resolve_spec(("batch",), (shape.global_batch,), mesh, rules)
    axes0 = bspec[0]
    if axes0 is None:
        dp = 1
    elif isinstance(axes0, tuple):
        dp = 1
        for a in axes0:
            dp *= mesh.shape[a]
    else:
        dp = mesh.shape[axes0]
    tp = mesh.shape.get("model", 1)
    b_loc = max(shape.global_batch // dp, 1)
    s = shape.seq_len if shape.kind != "decode" else 1
    dt = 2 if cfg.dtype == "bfloat16" else 4
    resid = b_loc * s * cfg.d_model * dt
    est = {"argument_bytes": rec["memory"]["argument_bytes"]}
    if shape.kind == "train":
        est["remat_residuals"] = cfg.num_layers * resid
        est["grads_f32"] = rec["memory"]["argument_bytes"] // 3  # ~params f32/ (p+m+v)
        chunk = min(cfg.attn_chunk, shape.seq_len)
        h_loc = max(cfg.num_heads // tp, 1)
        est["transient"] = max(
            4 * b_loc * h_loc * chunk * chunk * 4,  # attention logits block (f32)
            4 * b_loc * s * (cfg.d_ff // max(tp, 1) or cfg.d_ff) * dt,  # mlp h
        )
    else:
        est["transient"] = 4 * resid
    est["total"] = int(sum(v for v in est.values()))
    est[CAPACITY_KEY] = bool(est["total"] < R.HBM_CAPACITY_BYTES)
    return est


def cell_path(arch, shape_name, multi_pod, tag=""):
    mesh = "multi" if multi_pod else "single"
    suffix = f"__{tag}" if tag else ""
    return os.path.join(OUT_DIR, f"{arch}__{shape_name}__{mesh}{suffix}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--stack-mode", default="unroll", choices=("unroll", "scan"))
    ap.add_argument("--tag", default="", help="experiment tag for perf variants")
    ap.add_argument("--rules", default="default", choices=("default", "fsdp", "fsdp+zero1"),
                    help="sharding-rules preset")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (int/float/str)")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v

    os.makedirs(OUT_DIR, exist_ok=True)
    archs = list(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if len(set(meshes)) > 1:
        # one fake world a process: each mesh's cells in a process of its own
        import subprocess
        import sys

        rcs = [subprocess.call([sys.executable, "-m", "repro_torch.launch.dryrun",
                                *(argv if argv is not None else sys.argv[1:]),
                                "--mesh", "multi" if mp else "single"])
               for mp in meshes]
        raise SystemExit(max(rcs))

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                path = cell_path(arch, shape_name, multi_pod, args.tag)
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {path}")
                    continue
                label = f"{arch} x {shape_name} x {'multi' if multi_pod else 'single'}"
                print(f"[lower ] {label} ...", flush=True)
                try:
                    rec = run_cell(
                        arch, shape_name, multi_pod,
                        stack_mode=args.stack_mode, overrides=overrides,
                        tag=args.tag, rules_preset=args.rules,
                    )
                except Exception as e:  # noqa: BLE001 — record + continue the sweep
                    failures += 1
                    rec = {
                        "arch": arch, "shape": shape_name,
                        "multi_pod": multi_pod, "tag": args.tag,
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:],
                    }
                    print(f"[FAIL  ] {label}: {e}")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if "error" not in rec:
                    if rec.get("skipped"):
                        print(f"[skip  ] {label}: {rec['skipped']}")
                    else:
                        r = rec["roofline"]
                        counts = {k: v["count"] for k, v in rec["collective_summary"].items()}
                        print(
                            f"[ok    ] {label}: trace={rec['trace_s']}s "
                            f"flops/dev={rec['flops_per_device']:.3e} "
                            f"bound={r['bound']} "
                            f"terms(c/m/n)=({r['compute_s']:.4f},{r['memory_s']:.4f},"
                            f"{r['collective_s']:.4f})s colls={counts}",
                            flush=True,
                        )
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
