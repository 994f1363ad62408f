"""Node features that are not float32, through the PyTorch port against the
JAX package.

JAX runs with x64 off, so ``jnp.asarray`` turns float64 node features into
float32 and int64 into int32, and the encoder's masking
``jnp.where(mask, x, 0.0)`` promotes an integer encoder output to float32.
The port mirrors both (``core.graph.from_numpy`` and ``gnn.models.apply``):

  * ``from_numpy`` maps each numpy dtype as ``jnp.asarray`` does;
  * ``GNNEngine.infer_stream(device="cpu")`` for the six models x {int32,
    int64, float16, float64} node features matches JAX's engine on the
    same numpy inputs and converted parameters, at
    ``tests/test_torch_models.py``'s tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro.serve.gnn_engine import GNNEngine as JEngine
from repro_torch.core import graph as TG
from repro_torch.serve.gnn_engine import GNNEngine as TEngine
from test_torch_models import MODELS, _configs, _params, _tol

torch.set_num_threads(1)

DTYPES = (np.int32, np.int64, np.float16, np.float64)


def _graphs(dtype, n=4):
    """MOLHIV-shaped graphs with node features cast to ``dtype``; integer
    and bool features are small non-negative atom codes, as raw molecule
    data has."""
    out = []
    for s, r, nf, ef in (g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=3).take(n)):
        if not np.issubdtype(dtype, np.floating):
            nf = np.abs(np.rint(4 * nf))
        out.append((s, r, nf.astype(dtype), ef))
    return out


@pytest.mark.parametrize(
    "dtype", DTYPES + (np.float32, np.uint64, np.uint8, np.bool_))
def test_from_numpy_maps_dtypes_as_jax_does(dtype):
    s, r, nf, ef = _graphs(dtype, 1)[0]
    g = TG.from_numpy(s, r, nf, ef, n_pad=64, e_pad=192)
    want = np.dtype(jnp.asarray(nf).dtype)
    assert g.node_feat.dtype == torch.from_numpy(np.zeros(1, want)).dtype
    assert g.node_feat.shape == (64, nf.shape[1])


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("model", MODELS)
def test_stream_node_feature_dtypes_match_jax(model, dtype):
    jcfg, tcfg = _configs(model)
    jp, tp = _params(jcfg)
    dgn = tcfg.model == "dgn"
    graphs = _graphs(dtype)
    jouts, _, _ = JEngine(jcfg, jp).infer_stream(graphs, with_eigvec=dgn)
    touts, _, _ = TEngine(tcfg, tp, device="cpu").infer_stream(
        graphs, with_eigvec=dgn)
    want = np.concatenate(jouts)
    got = np.concatenate(touts)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                               **_tol(model))
