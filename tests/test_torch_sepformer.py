"""The port's SepFormer against the JAX package, on the CPU: every
dual-path block family, both norms, post-norm encoders and JAX's scan
layout of the encoder layers.

Toy widths (N 16, chunk 20, 4 heads, d_ffn 32; those of
tests/test_baselines_parity.py), numpy-seeded inputs, the JAX init loaded
with ``convert.load_jax_params``. Tolerances as tests/_torch_zoo_parity.py
states: forward rtol 1e-4, atol 1e-5; the grads of the PIT loss rtol 1e-4,
atol 1e-4 x each tensor's largest |grad|.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from _torch_zoo_parity import (
    assert_forward_matches,
    assert_pit_grads_match,
    brown_sources,
    jax_init,
    rand,
)
from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.models.baselines import sepformer as jsep
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.convert import load_jax_params, unstack_block_params
from sudo_rm_rf_tpu_torch.models.baselines import sepformer as tsep
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

HP = dict(encoder_kernel_size=16, encoder_out_nchannels=16, masknet_chunksize=20,
          masknet_numlayers=2, masknet_numspks=2, intra_numlayers=2, inter_numlayers=2,
          intra_nhead=4, inter_nhead=4, intra_dffn=32, inter_dffn=32, rnn_hidden=12)
CASES = {
    "transformer": {},
    "transformer_post_norm_gln": dict(intra_norm_before=False, inter_norm_before=False,
                                      masknet_norm="gln"),
    **{kind: dict(intra_block_type=kind, inter_block_type=kind,
                  masknet_useextralinearlayer=kind == "rnn")
       for kind in ("rnn", "dptnet", "pytorch", "fast")},
    "mixed_no_norm_no_skip": dict(intra_block_type="dptnet", inter_block_type="fast",
                                  masknet_norm="none", masknet_extraskipconnection=False),
}
LENGTH = 1601


def _hp(case):
    return dict(HP, **CASES[case])


@functools.lru_cache(maxsize=None)
def _jax_case(case, layout="unrolled"):
    x = rand((2, 1, LENGTH), 2)
    if layout == "scan":
        params = jsep.stack_sepformer_params(_jax_case(case)[1], 2, 2, 2)
        jmodel = jmodels.get_model("sepformer", **_hp(case), scan_layers=True)
        return jmodel, jax.tree.map(np.asarray, params), x
    jmodel = jmodels.get_model("sepformer", **_hp(case))
    return jmodel, jax_init(jmodel, x), x


def _port(case, layout="unrolled"):
    return load_jax_params(models.get_model("sepformer", **_hp(case)),
                           _jax_case(case, layout)[1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    jmodel, params, x = _jax_case(case)
    assert_forward_matches(jmodel, params, _port(case), x)


def test_scan_layout_forward_matches_jax():
    """JAX's scan_layers SepFormer from its stacked params, read by the port
    as the unrolled layers."""
    jmodel, params, x = _jax_case("transformer", "scan")
    assert "layers_scan" in params["masknet"]["dual_mdl_0"]["intra_mdl"]["mdl"]
    assert_forward_matches(jmodel, params, _port("transformer", "scan"), x)


def test_unstack_inverts_stack_sepformer_params():
    params = _jax_case("transformer")[1]
    back = unstack_block_params(_jax_case("transformer", "scan")[1])
    assert unstack_block_params(params) is params
    flat = lambda t: {jax.tree_util.keystr(k): v
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert sorted(flat(back)) == sorted(flat(params))
    for k, v in flat(params).items():
        np.testing.assert_array_equal(flat(back)[k], v, err_msg=k)


@pytest.mark.parametrize("case", ["transformer", "rnn"])
def test_pit_grads_match_jax(case):
    jmodel, params, x = _jax_case(case)
    assert_pit_grads_match(jmodel, params, _port(case), x, brown_sources(6, 2, 2, LENGTH))


def test_block_factory_and_extralinear_contract():
    with pytest.raises(ValueError, match="unknown dual-path block type"):
        tsep.make_block(dict(block_type="conformer"))
    with pytest.raises(ValueError, match="linear_layer_after_inter_intra"):
        models.get_model("sepformer", **dict(HP, intra_block_type="rnn"))
    m = models.get_model("sepformer", **_hp("rnn"))
    assert m.masknet.dual_mdl[0].intra_linear.weight.shape == (16, 24)
    # scan_layers is a no-op of the port: one param layout either way
    a = models.get_model("sepformer", **HP, generator=torch.Generator().manual_seed(1))
    b = models.get_model("sepformer", **HP, scan_layers=True,
                         generator=torch.Generator().manual_seed(1))
    for (k, v), (k2, v2) in zip(a.state_dict().items(), b.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)


def test_linear_attention_is_the_kernelized_quadratic_form():
    att = tsep._LinearAttention(16, 4, generator=torch.Generator().manual_seed(2))
    x = torch.from_numpy(rand((2, 24, 16), 3))
    with torch.no_grad():
        got = att(x).numpy()

    def heads(lin):
        return lin(x).reshape(2, 24, 4, 4).detach().numpy()

    def elu1(v):
        return np.where(v > 0, v, np.expm1(v)) + 1.0

    q, k, v = heads(att.q_proj), heads(att.k_proj), heads(att.v_proj)
    scores = np.einsum("blhd,bshd->bhls", elu1(q), elu1(k))
    weights = scores / (scores.sum(-1, keepdims=True) + 1e-6)
    naive = torch.from_numpy(np.einsum("bhls,bshd->blhd", weights, v).reshape(2, 24, 16))
    with torch.no_grad():
        want = att.out_proj(naive.float()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    blk = tsep.FastTransformerBlock(16, attention_type="reformer", num_layers=1, nhead=4,
                                    d_ffn=32, reformer_bucket_size=8)
    with torch.no_grad():
        y = blk(x)
    assert y.shape == x.shape and torch.isfinite(y).all()
