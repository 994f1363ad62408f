"""The port's kernel modules on the CPU: plain versions against the JAX
oracles, dispatch rules and the build.

  * ``node_mlp_ref`` and ``fused_mp_ref`` (every fp32 gamma, random
    operands in the style of ``tests/test_fused_mp.py``) match
    ``repro.kernels.ref`` at |a - b| <= 1e-5 + 1e-5 |b| (PNA: 5e-3, whose
    std amplifies one rounding of ``sqsum/c - mean^2``).
  * ``kernels.ops`` sends CPU tensors to the plain version, raises for
    ``mode="kernel"`` on a CPU tensor, and honours ``REPRO_KERNEL_MODE``.
  * The kernel wrappers refuse CPU tensors without launching; on CPU
    tensors ``kernels.ops`` runs int8 specs (JAX's answer within 2e-5).
  * ``csrc/quant_mlp.cu``'s row quantizer (multiply by the reciprocal,
    divide near half-integers), modelled in numpy float32, rounds as the
    IEEE quotient does on random rows and near-ties.
  * The CUDA kernels themselves are held against the plain versions in
    ``tests/test_torch_on_card.py`` (it skips without a card) and, at full
    size, by ``python3 chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import message_passing as JMP
from repro.kernels import ref as JREF
from repro_torch.core import message_passing as TMP
from repro_torch.kernels import _build
from repro_torch.kernels import fused_mp as FM
from repro_torch.kernels import node_mlp as NM
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quant_mlp as QM
from repro_torch.kernels import ref as TREF
from test_torch_on_card import (GAMMAS, PLAN_ARGS, PNA_TOL, TOL,
                                assert_close, exact_operands,
                                exact_plan_arrays, plan_arrays,
                                spec_operands, to_t)

torch.set_num_threads(1)

# ------------------------------------------------------ plain vs JAX oracle


@pytest.mark.parametrize("activation", ["relu", "gelu", "none"])
@pytest.mark.parametrize("shape", [(37, 9, 100), (64, 100, 200), (5, 200, 1)])
def test_node_mlp_ref_matches_jax(activation, shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * (2.0 / (k + n)) ** 0.5).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    want = JREF.node_mlp_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             activation)
    got = TREF.node_mlp_ref(to_t(x), to_t(w), to_t(b), activation)
    assert_close(got.numpy(), want, TOL)
    # ops dispatch: a CPU tensor takes the plain version
    auto = kops.node_mlp(to_t(x), to_t(w), to_t(b), activation)
    assert torch.equal(auto, got)


@pytest.mark.parametrize("gamma", GAMMAS)
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_mp_ref_matches_jax(gamma, seed):
    rng = np.random.default_rng(seed)
    plan = plan_arrays(rng)
    n, e = plan["in_degree"].shape[0], plan["ids_sorted"].shape[0]
    (phi, ops, _), kw = spec_operands(rng, gamma, n, e)
    jspec = JMP.MPSpec(phi, ops, gamma)
    tspec = TMP.MPSpec(phi, ops, gamma)
    names = ("ids_sorted", "src_sorted", "in_degree", "node_mask")
    want = JREF.fused_mp_ref(jspec, *(jnp.asarray(plan[k]) for k in names),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    got = kops.fused_mp(tspec, *(to_t(plan[k]) for k in PLAN_ARGS),
                        **{k: to_t(v) for k, v in kw.items()})
    assert_close(got.numpy(), want, PNA_TOL if gamma == "pna" else TOL)
    padded = ~plan["node_mask"]
    assert (got.numpy()[padded] == 0).all()


def test_fused_mp_ref_all_padding_edges():
    """No real edge at all: every accumulator is empty, max/min give 0."""
    rng = np.random.default_rng(3)
    n, e = 16, 24
    (phi, ops, gamma), kw = spec_operands(rng, "pna", n, e)
    ids = np.full((e,), n, np.int32)
    src = np.zeros((e,), np.int32)
    deg = np.zeros((n,), np.int32)
    mask = np.arange(n) < 13
    want = JREF.fused_mp_ref(JMP.MPSpec(phi, ops, gamma), jnp.asarray(ids),
                             jnp.asarray(src), jnp.asarray(deg),
                             jnp.asarray(mask),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    got = TREF.fused_mp_ref(TMP.MPSpec(phi, ops, gamma), to_t(ids), to_t(src),
                            to_t(deg), to_t(mask), **{k: to_t(v) for k, v in kw.items()})
    assert_close(got.numpy(), want, PNA_TOL)
    assert np.isfinite(got.numpy()).all()


def test_mpspec_validation():
    with pytest.raises(ValueError):
        TMP.MPSpec(phi="gather")
    with pytest.raises(ValueError):
        TMP.MPSpec(ops=())
    with pytest.raises(ValueError):
        TMP.MPSpec(ops=("mean",))
    with pytest.raises(ValueError):
        TMP.MPSpec(gamma="gat")
    with pytest.raises(ValueError):
        TMP.MPSpec(precision="fp16")
    assert TMP.MPSpec("add_relu", ("sum",), "gin") == TMP.MPSpec(
        "add_relu", ("sum",), "gin")


# ------------------------------------------------------------- dispatch


def _node_mlp_args():
    rng = np.random.default_rng(0)
    return (to_t(rng.normal(size=(4, 3)).astype(np.float32)),
            to_t(rng.normal(size=(3, 2)).astype(np.float32)),
            to_t(np.zeros(2, np.float32)))


def test_kernel_mode_on_cpu_tensor_raises():
    x, w, b = _node_mlp_args()
    before = NM.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        kops.node_mlp(x, w, b, mode="kernel")
    rng = np.random.default_rng(1)
    plan = plan_arrays(rng)
    (phi, ops, gamma), kw = spec_operands(rng, "gcn", 40, 96)
    with pytest.raises(RuntimeError, match="CUDA"):
        kops.fused_mp(TMP.MPSpec(phi, ops, gamma),
                      *(to_t(plan[k]) for k in PLAN_ARGS), mode="kernel",
                      **{k: to_t(v) for k, v in kw.items()})
    assert NM.launches == before


def test_env_override(monkeypatch):
    x, w, b = _node_mlp_args()
    monkeypatch.setenv("REPRO_KERNEL_MODE", "kernel")
    with pytest.raises(RuntimeError):
        kops.node_mlp(x, w, b)
    monkeypatch.setenv("REPRO_KERNEL_MODE", "reference")
    assert torch.equal(kops.node_mlp(x, w, b, mode="kernel"),
                       TREF.node_mlp_ref(x, w, b))
    monkeypatch.setenv("REPRO_KERNEL_MODE", "bogus")
    with pytest.raises(ValueError):
        kops.node_mlp(x, w, b)
    monkeypatch.delenv("REPRO_KERNEL_MODE")
    with pytest.raises(ValueError):
        kops.node_mlp(x, w, b, mode="interpret")


def test_wrappers_refuse_cpu_tensors_and_int8():
    """The kernel wrappers refuse CPU tensors, int8 specs and quantized
    operands included, without launching; on CPU tensors ``kernels.ops``
    accepts int8 and gives JAX's answer (the int8 plain versions are held
    against JAX in ``tests/test_torch_quant.py``)."""
    x, w, b = _node_mlp_args()
    before = (NM.launches, FM.launches, QM.launches)
    with pytest.raises(ValueError, match="CUDA"):
        NM.node_mlp(x, w, b)
    spec = TMP.MPSpec("copy", ("sum",), "gcn")
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        FM.fused_mp(spec, z, z, z, z.bool(), x, x)
    x_q, w_q = x.to(torch.int8), w.to(torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        QM.quant_node_mlp(x_q, w_q, torch.ones(2), b)
    rng = np.random.default_rng(2)
    plan = exact_plan_arrays(rng)
    n, e = plan["in_degree"].shape[0], plan["ids_sorted"].shape[0]
    (phi, ops, gamma), kw = exact_operands(rng, "pna", n, e)
    tspec = TMP.MPSpec(phi, ops, gamma, "int8")
    args = [to_t(plan[k]) for k in PLAN_ARGS]
    tkw = {k: to_t(v) for k, v in kw.items()}
    with pytest.raises(ValueError, match="CUDA"):
        FM.fused_mp(tspec, *args[1:], **tkw)
    got = kops.fused_mp(tspec, *args, **tkw)
    names = ("ids_sorted", "src_sorted", "in_degree", "node_mask")
    want = JREF.fused_mp_ref(JMP.MPSpec(phi, ops, gamma, "int8"),
                             *(jnp.asarray(plan[k]) for k in names),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    assert_close(got.numpy(), want, dict(rtol=0, atol=2e-5))
    # gcn's gamma has no linear: its int8 spec computes the fp32 layer
    (phi, ops, gamma), kw = spec_operands(rng, "gcn", n, e)
    kw = {k: to_t(v) for k, v in kw.items()}
    assert torch.equal(kops.fused_mp(TMP.MPSpec(phi, ops, gamma, "int8"), *args, **kw),
                       kops.fused_mp(TMP.MPSpec(phi, ops, gamma), *args, **kw))
    assert (NM.launches, FM.launches, QM.launches) == before


@pytest.mark.parametrize("gamma, f, n_ops, k1, h1, want", [
    ("gcn", 100, 1, 0, 0, 6_400),
    ("gin", 100, 1, 100, 200, 12_800 + 43_200 + 32_768),
    ("pna", 80, 4, 12 * 80, 0, 40_960 + 138_240 + 32_768),
    ("dgn", 100, 2, 3 * 100, 0, 25_600 + 43_200 + 32_768),
])
def test_fused_mp_shared_memory_fits_paper_widths(gamma, f, n_ops, k1, h1, want):
    """Every fp32 gamma at its paper width fits one block's shared memory at
    its rows (gcn 16, the others 32): the accumulators; the tower and GIN's
    hidden layer k-major at 36 words a k (K1 + H1 = 300, 960, 300); two
    staged 16 KB weight slices."""
    got = FM.smem_bytes(f, n_ops, k1, h1)
    assert got == want <= FM.MAX_SMEM_BYTES


@pytest.mark.parametrize("gamma, f, n_ops, k1, h1, want", [
    ("gin", 100, 1, 100, 200, 88_768 + 128 + 3_600),
    ("pna", 80, 4, 12 * 80, 0, 179_200 + 128 + 34_560 + 16_384),
    ("dgn", 100, 2, 3 * 100, 0, 68_800 + 128 + 10_800 + 16_384),
])
def test_fused_mp_int8_shared_memory_fits_paper_widths(gamma, f, n_ops, k1, h1,
                                                        want):
    """The int8 gamma adds 32 row scales and the int8 tile, four k to a word
    at 36 words a word (25, 240, 75 words deep); PNA's and DGN's staged
    slices are int8 (two of 8 KB), GIN's stay fp32 for w2."""
    got = FM.smem_bytes(f, n_ops, k1, h1, int8=True)
    assert got == want <= FM.MAX_SMEM_BYTES


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("gamma, f, n_ops, k1, h1", [
    ("gcn", 100, 1, 0, 0), ("gin", 100, 1, 100, 200),
    ("pna", 80, 4, 12 * 80, 0), ("dgn", 100, 2, 3 * 100, 0),
])
def test_fused_mp_paper_widths_take_32_rows(gamma, f, n_ops, k1, h1, int8):
    """Every paper-width gamma with a linear, in both precisions, runs 32
    destinations per block within 232,448 bytes; gcn, whose gamma has no
    product to widen (and no int8 linear), keeps 16."""
    int8 = int8 and gamma != "gcn"
    rows = 16 if gamma == "gcn" else 32
    assert FM.rows_for(f, n_ops, k1, h1, int8) == rows
    assert FM.smem_bytes(f, n_ops, k1, h1, int8, rows) <= FM.MAX_SMEM_BYTES == 232_448


@pytest.mark.parametrize("int8, want", [(False, 25_600 + 96_000 + 32_768),
                                         (True, 25_600 + 96_000 + 64 + 24_000 + 16_384)])
def test_fused_mp_rows_fall_back_to_16_past_the_limit(int8, want):
    """PNA at F = 100 (K1 1200) passes the limit at 32 rows and fits at 16;
    at F = 256 neither fits, and the wrapper refuses it (tested on the card)."""
    assert FM.smem_bytes(100, 4, 1200, 0, int8, 32) > FM.MAX_SMEM_BYTES
    assert FM.rows_for(100, 4, 1200, 0, int8) == 16
    assert FM.smem_bytes(100, 4, 1200, 0, int8, 16) == want
    assert FM.smem_bytes(256, 4, 12 * 256, 0, int8, 16) > FM.MAX_SMEM_BYTES


# ---------------------------------------------------------------- build


def test_build_targets_hopper_and_names_by_content():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path == _build.library_path(name)


def test_build_defines_name_a_separate_library(monkeypatch, tmp_path):
    """``-D`` names (the fused_mp phase marks) build their own library of a
    source; without them the served library is unchanged."""
    marks = ("FUSED_MP_PHASES",)
    assert _build.library_path("fused_mp", marks) != _build.library_path("fused_mp")
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    cmd = _build.nvcc_command("fused_mp", tmp_path / "x.so", marks)
    assert "-DFUSED_MP_PHASES" in cmd
    assert "-DFUSED_MP_PHASES" not in _build.nvcc_command("fused_mp", tmp_path / "x.so")


@pytest.mark.parametrize("argv", [[], ["--times"], ["--fma"]])
def test_fused_mp_phases_needs_a_card(capsys, argv):
    from repro_torch.kernels import fused_mp_phases

    assert fused_mp_phases.main(argv) == 1
    assert "CUDA" in capsys.readouterr().err


def test_quant_mlp_phases_needs_a_card(capsys):
    from repro_torch.kernels import quant_mlp_phases

    assert quant_mlp_phases.main([]) == 1
    assert "CUDA" in capsys.readouterr().err


def test_quant_node_mlp_dynamic_refuses_cpu_tensors():
    """The dynamic entry's wrapper launches nothing for CPU tensors, and
    ``mode="kernel"`` on them raises; ``mode="auto"`` runs the plain
    version (``kernels.ref.quant_node_mlp_dynamic_ref``)."""
    x = torch.randn(5, 4)
    w_q = torch.ones((4, 3), dtype=torch.int8)
    args = (x, w_q, torch.ones(3), torch.zeros(3))
    before = dict(QM.launches_by_entry)
    with pytest.raises(ValueError, match="CUDA"):
        QM.quant_node_mlp_dynamic(*args)
    with pytest.raises(RuntimeError, match="CUDA"):
        kops.quant_node_mlp_dynamic(*args, mode="kernel")
    assert torch.equal(kops.quant_node_mlp_dynamic(*args),
                       TREF.quant_node_mlp_dynamic_ref(*args))
    assert QM.launches_by_entry == before


def _quantize_like_the_kernel(x, rs):
    """``csrc/quant_mlp.cu:quantize4`` in numpy float32: q0 = RN(x * RN(1 /
    rs)), the IEEE quotient only where q0 lies within 2^-20 |q0| of a
    half-integer, then rint and clamp.  -> (q, fallback mask)."""
    f32 = np.float32
    q0 = (x * (f32(1) / rs).astype(f32)).astype(f32)
    near = np.abs(q0 - (np.floor(q0) + f32(0.5))) <= np.abs(q0) * f32(2.0 ** -20)
    q = np.where(near, (x / rs).astype(f32), q0)
    return np.clip(np.rint(q), -128, 127), near


def test_quant_mlp_quantizer_rounds_as_the_ieee_quotient():
    """The dynamic entry's quantizer gives rint(RN(x / rs)) clamped, as
    qconfig's recipe does, on random rows at binades 2^-30 .. 2^30 and on
    near-ties: (j + 1/2) rs moved by 0 .. 8 ulps either way (the cases a
    multiplication by the reciprocal can round across).  RN(1 / rs) within
    half an ulp makes q0 within 1.5 ulp of x / rs, so a window of 2^-20 |q0|
    around each half-integer leaves every other value on the quotient's
    side."""
    rng = np.random.default_rng(19)
    f32 = np.float32
    m = (np.exp2(rng.uniform(-30, 30, 20000)) * rng.uniform(1, 2, 20000)).astype(f32)
    rs = (np.maximum(m, f32(1e-8)) / f32(127)).astype(f32)
    xs = [(rng.uniform(-1, 1, m.size) * m).astype(f32), m, -m]
    ties = ((rng.integers(-128, 127, m.size) + f32(0.5)) * rs).astype(f32)
    for direction in (np.inf, -np.inf):
        t = ties.copy()
        for _ in range(9):
            xs.append(t)
            t = np.nextafter(t, f32(direction)).astype(f32)
    fallbacks = []
    for x in xs:
        got, near = _quantize_like_the_kernel(x, rs)
        want = np.clip(np.rint((x / rs).astype(f32)), -128, 127)
        np.testing.assert_array_equal(got, want)
        fallbacks.append(near.mean())
    # the division runs for (nearly) every near-tie, for few random values
    assert fallbacks[0] < 1e-3 and min(fallbacks[3:]) > 0.5


def test_fused_mp_wrapper_has_one_library():
    """The served wrapper loads only the plain build of fused_mp.cu: the
    phase tool launches its marked build through ``launch_args`` /
    ``launch`` and nothing in the wrapper selects a library."""
    assert not hasattr(FM, "defines")
    assert (_build.CSRC / "fma_probe.cu").is_file()
    assert "fma_probe" not in _build.SOURCES


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
