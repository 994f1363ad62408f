"""The port's COO -> compressed conversion (``repro_torch.core.graph``:
``CSRGraph``, ``coo_to_compressed``, ``out_degree``) against the JAX
package's, bit for bit, on random padded graphs (seeded numpy): offsets,
permutation, sorted endpoints and degrees for both orders, padding edges
keyed ``N_pad`` (so they sort last) and the stable order within a row."""
import numpy as np
import pytest

from repro.core import graph as JG
from repro_torch import core as TC
from repro_torch.core import graph as TG


def _graph(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    e = int(rng.integers(0, 4 * n + 1))
    n_pad = n + int(rng.integers(0, 9))
    e_pad = max(e + int(rng.integers(0, 17)), 1)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    nf = rng.normal(size=(n, 3)).astype(np.float32)
    return (JG.from_numpy(s, r, nf, n_pad=n_pad, e_pad=e_pad),
            TG.from_numpy(s, r, nf, n_pad=n_pad, e_pad=e_pad))


@pytest.mark.parametrize("order", ["csr", "csc"])
@pytest.mark.parametrize("seed", range(12))
def test_coo_to_compressed_equals_jax_bit_for_bit(seed, order):
    jg, tg = _graph(seed)
    want = JG.coo_to_compressed(jg, order=order)
    got = TG.coo_to_compressed(tg, order=order)
    assert isinstance(got, TC.CSRGraph)
    for field in ("offsets", "perm", "src_sorted", "dst_sorted", "degree"):
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.dtype == w.dtype == np.int32, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    n_real = int(tg.edge_mask.sum())
    assert int(got.offsets[-1]) == n_real  # padding edges sort past every row


@pytest.mark.parametrize("seed", range(12))
def test_degrees_equal_jax(seed):
    jg, tg = _graph(seed)
    for jf, tf in ((JG.out_degree, TG.out_degree), (JG.in_degree, TG.in_degree)):
        np.testing.assert_array_equal(tf(tg).numpy(), np.asarray(jf(jg)))
    csr = TC.coo_to_compressed(tg, "csr")
    np.testing.assert_array_equal(csr.degree.numpy(), TC.out_degree(tg).numpy())


def test_core_exports_are_jax_s():
    import repro.core as JC

    assert sorted(TC.__all__) == sorted(JC.__all__)
    for name in TC.__all__:
        assert getattr(TC, name) is not None


def test_unknown_order_raises():
    _, tg = _graph(0)
    with pytest.raises(ValueError):
        TG.coo_to_compressed(tg, order="coo")
