"""The port's attentive SuDoRM-RF v1-v3 against the JAX package, on the CPU.

Toy hparams of tests/test_registry_smoke.py (out 16, in 32, depth 3, basis
16) at two blocks; v1 at 2 heads of 8 dims (it takes the constructor's
attention arguments), v2 and v3 at their hardcoded 4 heads of 256 dims;
odd lengths, numpy-seeded inputs, the JAX init loaded with
``convert.load_jax_params``, from the unrolled (``sm_{i}``) and from the
scan layout (``sm_scan/block``, ``scan_blocks=True``). Tolerances as
tests/_torch_zoo_parity.py states; the positional encodings within 1e-6;
``sudo-torch-evaluate``'s SI-SDR keys within 1e-3 dB and BSS-eval keys
within 1e-2 dB of the JAX CLI's, as tests/test_torch_evaluate.py holds
them. Dropout masks cannot match JAX's threefry draws, so dropout is held to
its own contract: the keep fraction, the x/keep scaling, eval determinism,
one generator seed giving one output, no use of the global RNG.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from _torch_zoo_parity import (
    assert_checkpoints_round_trip,
    assert_forward_matches,
    assert_grads_match,
    assert_separate_cli_matches_jax,
    assert_train_step_matches,
    brown_sources,
    jax_draws,
    jax_init,
    rand,
)
from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.models import attentive as jatt
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.config import ModelConfig
from sudo_rm_rf_tpu_torch.convert import load_jax_params, unstack_block_params
from sudo_rm_rf_tpu_torch.models import attentive as tatt
from sudo_rm_rf_tpu_torch.train import trainer as ttrainer
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

HP = dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3,
          enc_kernel_size=21, enc_num_basis=16, num_sources=2)
TYPES = {"v1": "attention", "v2": "attention_v2", "v3": "attention_v3"}
EXTRA = {"v1": dict(n_heads=2, att_dims=8)}
LENGTH = 661


def _hp(variant):
    return dict(HP, **EXTRA.get(variant, {}))


@functools.lru_cache(maxsize=None)
def _jax_case(variant, layout="unrolled"):
    """(JAX model, params, input); the scan layout's params are the
    unrolled ones stacked, so both layouts hold the same weights."""
    x = rand((2, 1, LENGTH), 3)
    scan = layout == "scan"
    jmodel = jmodels.get_model(TYPES[variant], **_hp(variant), scan_blocks=scan)
    if not scan:
        return jmodel, jax_init(jmodel, x), x
    params = jatt.stack_block_params(_jax_case(variant)[1], HP["num_blocks"])
    return jmodel, jax.tree.map(np.asarray, params), x


def _port(variant, layout="unrolled"):
    return load_jax_params(models.get_model(TYPES[variant], **_hp(variant)),
                           _jax_case(variant, layout)[1])


@pytest.mark.parametrize("layout", ["unrolled", "scan"])
@pytest.mark.parametrize("variant", sorted(TYPES))
def test_forward_matches_jax(variant, layout):
    jmodel, params, x = _jax_case(variant, layout)
    assert ("sm_scan" in params) == (layout == "scan")
    assert_forward_matches(jmodel, params, _port(variant, layout), x)


@pytest.mark.parametrize("variant", sorted(TYPES))
def test_grads_match_jax(variant):
    jmodel, params, x = _jax_case(variant)
    assert_grads_match(jmodel, params, _port(variant), x)


@pytest.mark.parametrize("variant", sorted(TYPES))
def test_train_step_matches_jax(variant):
    """Dropout off, as JAX's Trainer steps without ``train_dropout``; the
    clamp off, as the random v1 toy's SI-SDR sits at -33 dB on the batches
    tried, past the default clamp of 30."""
    jmodel, params, _ = _jax_case(variant)
    assert_train_step_matches(jmodel, params, _port(variant), brown_sources(7, 4, 2, 1000),
                              loss_clamp=0.0)


def test_unstack_block_params_inverts_jax_stacking():
    params = _jax_case("v3")[1]
    back = unstack_block_params(_jax_case("v3", "scan")[1])
    flat = lambda t: {jax.tree_util.keystr(k): v
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert sorted(flat(back)) == sorted(flat(params))
    for k, v in flat(params).items():
        np.testing.assert_array_equal(flat(back)[k], v, err_msg=k)
    assert unstack_block_params(params) is params


def test_v2_v3_hardcode_their_block_attention():
    """v2 and v3 build 4 heads of 256 dims and dropout 0.1 whatever the
    constructor says; v1 takes what it is given."""
    for variant in ("v2", "v3"):
        m = models.get_model(TYPES[variant], **HP, n_heads=2, att_dims=8, att_dropout=0.5)
        assert (m.n_heads, m.att_dims, m.att_dropout) == (4, 256, 0.1)
        layer = (m.sm[0].attentive_resamplers[0] if variant == "v3" else m.sm[0].attention)
        assert layer.mha.Q_proj.weight.shape == (1024, 32) and layer.mha.n_heads == 4
        assert layer.pe_drop.rate == 0.1
    m = models.get_model("attention", **HP, n_heads=2, att_dims=8, att_dropout=0.5)
    assert m.sm[0].attention.mha.in_proj_weight.shape == (24, 8)
    assert m.sm[0].attention.mha.num_heads == 2 and m.sm[0].attention.pe_drop.rate == 0.5
    assert len(m.sm[0].attention.mha.out_proj.weight) == 8


def test_v3_resamplers_query_the_shallower_level():
    """v3's resampler i takes q from level depth-2-i and k/v from the level
    below it: its output has the query's length."""
    m = _port("v3")
    seen = []
    for i, layer in enumerate(m.sm[0].attentive_resamplers):
        layer.register_forward_hook(lambda mod, args, out, i=i: seen.append(
            (i, args[0].shape[-1], args[1].shape[-1], out.shape[-1])))
    with torch.no_grad():
        m(torch.from_numpy(rand((1, 1, 640), 4)))
    assert seen[:2] == [(0, 32, 16, 32), (1, 64, 32, 64)]


def test_positional_encoding_matches_jax_and_is_not_a_buffer(tmp_path):
    for length, d in ((37, 8), (200, 32), (5, 7)):
        got = tatt.sinusoidal_pe(length, d).numpy()
        np.testing.assert_allclose(got, np.asarray(jatt.sinusoidal_pe(length, d)),
                                   rtol=0, atol=1e-6)
    port = _port("v2")
    assert not any(k.split(".")[-1] == "pe" for k in port.state_dict())
    # a torch checkpoint of the reference keeps ``pe`` buffers: they are dropped
    sd = dict(port.state_dict())
    sd["sm.0.attention.pos_enc.pe"] = torch.zeros(1, 50, 32)
    sd["sm.0.attention.num_batches_tracked"] = torch.tensor(0)
    torch.save(sd, tmp_path / "v2.pt")
    back = models.load_checkpoint_model("attention_v2", HP, str(tmp_path / "v2.pt"), "cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


# -- dropout ------------------------------------------------------------------


def test_dropout_contract():
    drop = tatt.Dropout(0.25)
    x = torch.full((200_000,), 3.0)
    assert torch.equal(drop(x), x)  # no generator: deterministic
    drop.generator = torch.Generator().manual_seed(1)
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 3.0 / 0.75))
    drop.generator.manual_seed(1)
    torch.manual_seed(123)  # the global RNG plays no part
    assert torch.equal(drop(x), y)
    drop.generator.manual_seed(2)
    assert not torch.equal(drop(x), y)
    drop.eval()
    assert torch.equal(drop(x), x)
    assert torch.equal(tatt.Dropout(0.0).train()(x), x)


def _dropout_step(variant, seed, train_dropout=True):
    model = _port(variant)
    tr = ttrainer.Trainer(model, ttrainer.TrainerConfig(
        loss_clamp=0.0, train_dropout=train_dropout, dropout_seed=seed))
    batch = brown_sources(7, 4, 2, 1000)
    _, m = tr.train_step(tr.init_state(), batch, jax_draws(jax.random.key(3), 4, 2))
    return tr, float(m["loss"]), batch


@pytest.mark.parametrize("variant", sorted(TYPES))
def test_trainer_dropout_is_seeded_and_eval_is_deterministic(variant):
    tr, loss, batch = _dropout_step(variant, 5)
    # train mode for the step's forward and backward only
    assert not tr.model.training and tr.dropout_generator is not None
    assert _dropout_step(variant, 5)[1] == loss
    assert _dropout_step(variant, 6)[1] != loss
    assert _dropout_step(variant, 5, train_dropout=False)[1] != loss
    mix = batch.sum(1, keepdims=True)
    a = tr.eval_step(tr.model, mix, batch)["SISDRi"]
    b = tr.eval_step(tr.model, mix, batch)["SISDRi"]
    assert torch.equal(a, b)


def test_trainer_dropout_needs_dropout_layers():
    with pytest.raises(ValueError, match="no dropout layers"):
        ttrainer.Trainer(models.get_model("relu", **HP),
                         ttrainer.TrainerConfig(train_dropout=True))


# -- config, CLIs, checkpoints ------------------------------------------------


def test_config_passes_the_attention_arguments():
    cfg = ModelConfig(model_type="attention", out_channels=16, in_channels=32, num_blocks=1,
                      upsampling_depth=3, enc_num_basis=16, n_heads=2, att_dims=8,
                      att_dropout=0.2, scan_blocks=True, remat_blocks=True)
    m = cfg.build()
    assert (m.n_heads, m.att_dims, m.att_dropout, m.scan_blocks) == (2, 8, 0.2, True)


@pytest.mark.parametrize("variant", sorted(TYPES))
def test_separate_cli_matches_jax_cli(tmp_path, variant):
    """The JAX CLI builds the attentive models with their default attention
    arguments, so v1 runs at 4 heads of 256 dims here."""
    port = models.get_model(TYPES[variant], **HP, generator=torch.Generator().manual_seed(3))
    assert_separate_cli_matches_jax(tmp_path, TYPES[variant], HP, port)


def test_evaluate_cli_passes_heads_and_dims_and_matches_jax(tmp_path, capsys):
    from sudo_rm_rf_tpu.cli.evaluate import main as jax_main
    from sudo_rm_rf_tpu_torch.cli.evaluate import main
    from sudo_rm_rf_tpu_torch.data.synthetic import write_whamr_corpus

    root = write_whamr_corpus(str(tmp_path / "whamr"), n_train=0, n_val=0, n_test=2,
                              seconds=(0.75, 1.0), fs=8000, seed=6)
    model = models.get_model("attention", **_hp("v1"), generator=torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "v1.pt")
    argv = ["--checkpoint", str(tmp_path / "v1.pt"), "--model_type", "attention",
            "--root_dirpath", root, "--timelength", "0.75", "--batch_size", "2",
            "--dataset", "WHAMR", "--separation_task", "noisy_reverberant", "-fs", "8000",
            "--bss_filter_taps", "1", "--n_heads", "2", "--att_dims", "8"]
    for k in ("out_channels", "in_channels", "num_blocks", "upsampling_depth",
              "enc_kernel_size", "enc_num_basis"):
        argv += [f"--{k}", str(HP[k])]
    runs = []
    for fn, extra in ((jax_main, []), (main, ["--device", "cpu"])):
        assert fn(argv + extra) == 0
        runs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    want, got = runs
    assert sorted(got) == sorted(want) and got["n_examples"] == 2
    for key, w in want.items():
        if isinstance(w, float):
            assert abs(got[key] - w) <= (1e-3 if key.startswith("si_sdr") else 1e-2), key


@pytest.mark.parametrize("variant", ["v1", "v3"])
def test_checkpoints_round_trip(tmp_path, variant):
    jmodel, params, x = _jax_case(variant)
    assert_checkpoints_round_trip(tmp_path, TYPES[variant], _hp(variant), jmodel, params,
                                  _port(variant), x)


def test_a_jax_scan_layout_train_state_resumes_in_the_port(tmp_path):
    """A JAX TrainState of a ``scan_blocks`` model (params and Adam moments
    stacked) restored by the port's CheckpointManager."""
    from sudo_rm_rf_tpu.parallel import make_mesh
    from sudo_rm_rf_tpu.train import trainer as jtrainer
    from sudo_rm_rf_tpu.utils import checkpoint as jcheckpoint
    from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import params_to_state_dict
    from sudo_rm_rf_tpu_torch.utils import CheckpointManager

    jmodel, params, _ = _jax_case("v2", "scan")
    jt = jtrainer.Trainer(jmodel, jtrainer.TrainerConfig(loss_clamp=0.0),
                          mesh=make_mesh(devices=jax.devices()[:1]))
    jstate, _ = jt.train_step(jt.state_from_params(params),
                              brown_sources(8, 4, 2, 1000), jax.random.key(2))
    jcheckpoint.CheckpointManager(str(tmp_path), "attention_v2").save(jstate, "e1")
    port = models.get_model("attention_v2", **HP)
    state = CheckpointManager(str(tmp_path), "attention_v2").restore(
        ttrainer.Trainer(port).init_state(), "e1")
    assert state.step == 1
    unrolled = unstack_block_params(jax.tree.map(np.asarray, jstate.params))
    want = params_to_state_dict(unrolled, port.state_dict().keys())
    mu = params_to_state_dict(unstack_block_params(jax.tree.map(
        np.asarray, jstate.opt_state[1][0].mu)), port.state_dict().keys())
    for name, p in port.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].reshape(p.shape).numpy())
        np.testing.assert_array_equal(state.optimizer.state[p]["exp_avg"].numpy(),
                                      mu[name].reshape(p.shape).numpy())
