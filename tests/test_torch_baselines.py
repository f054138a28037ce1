"""The port's ConvTasNet, DPRNN, Demucs, TDCN and ResidualTN against the JAX
package, on the CPU (SepFormer: tests/test_torch_sepformer.py).

Toy widths (those of tests/test_baselines_parity.py; ResidualTN at R x X =
28, the least its residual table takes), numpy-seeded inputs, the JAX init
loaded with ``convert.load_jax_params``. Tolerances as
tests/_torch_zoo_parity.py states: forward rtol 1e-4, atol 1e-5; the grads
of the PIT loss rtol 1e-4, atol 1e-4 x each tensor's largest |grad|. The
published configurations are built on the ``meta`` device only (Demucs has
415.09 M params).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_parity import (
    assert_checkpoints_round_trip,
    assert_forward_matches,
    assert_pit_grads_match,
    brown_sources,
    jax_init,
    rand,
)
from sudo_rm_rf_tpu import config as jconfig
from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu import ops as jops
from sudo_rm_rf_tpu_torch import models, ops
from sudo_rm_rf_tpu_torch.config import ModelConfig
from sudo_rm_rf_tpu_torch.convert import load_jax_params
from sudo_rm_rf_tpu_torch.models.baselines import demucs as tdemucs
from sudo_rm_rf_tpu_torch.models.baselines.layers import torch_lstm
from sudo_rm_rf_tpu_torch.models.layers import Conv1d, ConvTranspose1d
from sudo_rm_rf_tpu_torch.utils import CheckpointManager, benchmark
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

CASES = {
    "convtasnet": ("convtasnet", dict(enc_dim=48, feature_dim=16, layer=3, stack=2),
                   (2, 1, 3210)),
    "convtasnet_causal": ("convtasnet", dict(enc_dim=48, feature_dim=16, layer=3, stack=2,
                                             causal=True), (2, 1, 3210)),
    "dprnn": ("dprnn", dict(enc_dim=32, feature_dim=16, hidden_dim=24, layer=2,
                            segment_size=20), (2, 1, 1600)),
    "demucs": ("demucs", dict(channels=8, depth=3, lstm_layers=2), (2, 1, 4000)),
    "demucs_upsample": ("demucs", dict(channels=8, depth=2, lstm_layers=1, upsample=True),
                        (1, 1, 4000)),
    "tdcn": ("tdcn", dict(N=32, B=16, H=24, X=3, R=2), (2, 1, 3200)),
    "residual_tdcn": ("residual_tdcn", dict(N=32, B=16, H=24, X=7, R=4), (1, 1, 1600)),
}
# the published parameter counts of the class defaults
PUBLISHED = {"convtasnet": 5_050_545, "dprnn": 2_633_729, "demucs": 415_090_082,
             "tdcn": 8_628_038, "residual_tdcn": 9_420_102, "sepformer": 25_679_361}


def _randomize_running_stats(params):
    """ResidualTN's BatchNorm running stats away from their init (0, 1), so
    their mapping and their gradients are exercised."""
    rng = np.random.default_rng(9)

    def visit(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                visit(v)
            elif k == "running_mean":
                tree[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
            elif k == "running_var":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    visit(params)
    return params


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    model_type, hp, shape = CASES[case]
    x = rand(shape, 1)
    jmodel = jmodels.get_model(model_type, **hp)
    params = jax_init(jmodel, x)
    if model_type == "residual_tdcn":
        params = _randomize_running_stats(jax.tree.map(np.array, params))
    return jmodel, params, x


def _port(case):
    model_type, hp, _ = CASES[case]
    return load_jax_params(models.get_model(model_type, **hp), _jax_case(case)[1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    jmodel, params, x = _jax_case(case)
    assert_forward_matches(jmodel, params, _port(case), x)


@pytest.mark.parametrize("case", ["convtasnet", "convtasnet_causal", "dprnn", "demucs",
                                  "tdcn", "residual_tdcn"])
def test_pit_grads_match_jax(case):
    """Grads of the PIT negative SI-SDR against brown-noise targets,
    ResidualTN's trainable running statistics among them."""
    jmodel, params, x = _jax_case(case)
    port = _port(case)
    targets = brown_sources(5, x.shape[0], 2, x.shape[-1])
    assert_pit_grads_match(jmodel, params, port, x, targets, zero_grads=(
        "decoder.2.2.bias", "be.bias"))
    if case == "residual_tdcn":
        assert port.ln.running_var.grad.abs().max() > 0


def test_norms_match_jax():
    x = rand((2, 6, 50), 2)
    g, b = rand((6,), 3), rand((6,), 4)
    for name in ("channel_ln", "cumulative_ln", "glob_ln"):
        want = np.asarray(getattr(jops.norm, name)(jnp.asarray(x), jnp.asarray(g),
                                                   jnp.asarray(b)))
        got = getattr(ops, name)(torch.from_numpy(x), torch.from_numpy(g),
                                 torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)


def test_causal_convtasnet_is_causal():
    """A change at sample t moves no output before t - win (the encoder's
    window reaches that far back)."""
    model = models.get_model("convtasnet", **CASES["convtasnet_causal"][1]).eval()
    x = torch.from_numpy(rand((1, 1, 1600), 6))
    y = x.clone()
    y[..., 1000:] += 1.0
    with torch.no_grad():
        a, b = model(x), model(y)
    assert torch.equal(a[..., :1000 - model.win_samples], b[..., :1000 - model.win_samples])
    assert not torch.equal(a, b)


def test_residual_tdcn_table_and_batchnorm_are_jax_s():
    m = models.get_model("residual_tdcn", **CASES["residual_tdcn"][1])
    assert m.norm_of == {-1: 0, 3: 1, 8: 2, 11: 3, 16: 4, 19: 5}
    assert m.dense_of == {8: 0, 11: 1, 16: 2, 19: 3, 24: 4, 27: 5}
    assert [d.weight.shape[1] for d in m.residual_denses] == [16, 16, 32, 32, 48, 48]
    # the running statistics are params, and train mode normalizes by them
    names = dict(m.named_parameters())
    assert "ln.running_mean" in names and "ln_mask_in.running_var" in names
    x = torch.from_numpy(rand((1, 1, 800), 7))
    with torch.no_grad():
        assert torch.equal(m.train()(x), m.eval()(x))
    with pytest.raises(ValueError, match="R \\* X >= 28"):
        models.get_model("residual_tdcn", X=3, R=2)


def test_lstms_draw_from_the_generator_only():
    """The LSTMs take their init from the explicit generator (uniform in
    +-1/sqrt(H)), never from the global RNG; one seed gives one model."""
    torch.manual_seed(0)
    before = torch.get_rng_state()
    a = torch_lstm(5, 6, 2, True, generator=torch.Generator().manual_seed(3))
    assert torch.equal(torch.get_rng_state(), before)
    b = torch_lstm(5, 6, 2, True, generator=torch.Generator().manual_seed(3))
    names = torch.nn.LSTM(5, 6, 2, bidirectional=True, device="meta").named_parameters()
    assert sorted(dict(a.named_parameters())) == sorted(dict(names))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q) and p.abs().max() <= 1 / np.sqrt(6), n
    # the CPU forward is torch's own LSTM
    out, _ = a(torch.from_numpy(rand((2, 7, 5), 8)))
    assert out.shape == (2, 7, 12)


def test_demucs_rescales_its_fresh_init(monkeypatch):
    """Each conv's weight and bias divided by sqrt(std(weight) / 0.1), as
    upstream rescales a fresh Demucs (against the same draws unscaled)."""
    hp = CASES["demucs"][1]
    scaled = models.get_model("demucs", **hp, generator=torch.Generator().manual_seed(1))
    monkeypatch.setattr(tdemucs, "RESCALE", 0)
    plain = models.get_model("demucs", **hp, generator=torch.Generator().manual_seed(1))
    convs = 0
    for (name, m), (_, s) in zip(plain.named_modules(), scaled.named_modules()):
        if isinstance(m, (Conv1d, ConvTranspose1d)):
            scale = (m.weight.std() / 0.1).sqrt()
            torch.testing.assert_close(s.weight, m.weight / scale, msg=name)
            torch.testing.assert_close(s.bias, m.bias / scale, msg=name)
            convs += 1
    assert convs == 3 * 2 + 3 * 2  # each level's conv and rewrite, both ways
    assert torch.equal(plain.lstm.lstm.weight_hh_l0, scaled.lstm.lstm.weight_hh_l0)


def test_published_configs_and_the_zoo_rows():
    """Every baseline at its class defaults has the JAX class's param count
    (the published configurations); the zoo builds every row, the baselines
    at the JAX rows' defaults, seeded. Built on the meta device."""
    with torch.device("meta"):
        for name, count in PUBLISHED.items():
            assert benchmark.count_params(models.get_model(name)) == count, name
        zoo = benchmark.reference_model_zoo()
        for name in ("convtasnet", "dprnn", "demucs", "tdcn", "sepformer"):
            model = zoo[name]()
            assert type(model) is type(models.get_model(name))
            assert benchmark.count_params(model) == PUBLISHED[name], name
    assert zoo["sepformer"].keywords["scan_layers"] is True
    # the JAX package's counts, from its shapes
    for name in ("convtasnet", "tdcn", "residual_tdcn", "dprnn"):
        shapes = jax.eval_shape(jmodels.get_model(name).init, jax.random.key(0),
                                jnp.zeros((1, 1, 4000)))
        assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == PUBLISHED[name]


def test_lstm_flops_are_counted_from_their_shapes():
    """On the meta device an LSTM decomposes into per-step products, which
    FlopCounterMode counts as 8 H (I + H) T a direction, batch and layer; the
    bench counts that from the shapes (the decomposition of the published
    DPRNN takes ~30 s of host time), and the totals agree."""
    lstm = torch_lstm(16, 24, 2, True)
    got = benchmark.count_flops(benchmark.on_meta(lstm), torch.empty((3, 50, 16), device="meta"))
    assert got == benchmark.lstm_flops(lstm, 3, 50) == 3 * 50 * 2 * 8 * 24 * (
        (16 + 24) + (48 + 24))
    for case in ("dprnn", "demucs"):
        model = models.get_model(CASES[case][0], **CASES[case][1])
        decomposed = benchmark.count_flops(benchmark.on_meta(model),
                                           torch.empty((2, 1, 1600), device="meta"))
        assert benchmark.forward_flops(model, 2, 1600) == decomposed
        assert benchmark.backward_flops(model, 2, 1600) == 3 * decomposed


def test_config_and_the_clis_refuse_a_baseline_as_jax_cannot_build_one(tmp_path):
    """The JAX package's ModelConfig.build passes the SuDoRM-RF hparams to
    every model type, so it and its CLIs raise a TypeError for a baseline;
    the port raises a ValueError that says so."""
    from sudo_rm_rf_tpu.cli.evaluate import main as jax_evaluate
    from sudo_rm_rf_tpu.cli.export import main as jax_export
    from sudo_rm_rf_tpu.cli.separate import main as jax_separate
    from sudo_rm_rf_tpu_torch.cli.evaluate import main as evaluate
    from sudo_rm_rf_tpu_torch.cli.export import main as export
    from sudo_rm_rf_tpu_torch.cli.separate import main as separate

    for name in models.BASELINES:
        with pytest.raises(TypeError, match="unexpected keyword argument"):
            jconfig.ModelConfig(model_type=name).build()
        with pytest.raises(ValueError, match="ROADMAP queue 3"):
            ModelConfig(model_type=name).build()
    ckpt = str(tmp_path / "absent_ckpt")
    common = ["--checkpoint", ckpt, "--model_type", "dprnn"]
    argvs = {"separate": common + ["--input", "absent.wav"],
             "evaluate": common + ["--dataset", "WHAM", "--root_dirpath", str(tmp_path)],
             "export": common + ["--out", str(tmp_path / "m.pt")]}
    for jax_main, port_main, kind in ((jax_separate, separate, "separate"),
                                      (jax_evaluate, evaluate, "evaluate"),
                                      (jax_export, export, "export")):
        with pytest.raises(TypeError, match="unexpected keyword argument"):
            jax_main(argvs[kind])
        device = [] if kind == "export" else ["--device", "cpu"]
        with pytest.raises(ValueError, match="ROADMAP queue 3"):
            port_main(argvs[kind] + device)


@pytest.mark.parametrize("case", ["residual_tdcn", "dprnn"])
def test_load_checkpoint_model_loads_a_baseline_strictly(tmp_path, case):
    model_type, hp, _ = CASES[case]
    port = _port(case)
    sd = dict(port.state_dict())
    if model_type == "residual_tdcn":
        # a reference .pt's BatchNorm step counts are dropped
        sd["ln.num_batches_tracked"] = torch.tensor(7)
    torch.save(sd, tmp_path / "m.pt")
    back = models.load_checkpoint_model(model_type, hp, str(tmp_path / "m.pt"), "cpu")
    assert not back.training
    for k, v in port.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    sd["extra.weight"] = torch.zeros(1)
    torch.save(sd, tmp_path / "bad.pt")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        models.load_checkpoint_model(model_type, hp, str(tmp_path / "bad.pt"), "cpu")


def test_a_param_the_loss_misses_steps_with_a_zero_grad(tmp_path):
    """ConvTasNet's last residual conv feeds nothing the output reads: torch
    leaves its ``.grad`` None, JAX steps it with zeros. The trainer steps it
    with zeros too, so every param's count moves together and the TrainState
    saves; the param moves only by its earlier momentum (none here)."""
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_remix

    model = _port("convtasnet")
    dead = model.TCN.TCN[-1].res_out.weight
    before = dead.detach().clone()
    for optimizer in ("adam", "radam_cosine"):
        tr = Trainer(model, TrainerConfig(optimizer=optimizer, warmup_steps=1, total_steps=4,
                                          loss_clamp=0.0))
        state = tr.init_state()
        for _ in range(2):
            state, m = tr.train_step(state, brown_sources(4, 2, 2, 1610),
                                     draw_remix(torch.Generator().manual_seed(0), 2, 2))
        assert np.isfinite(float(m["loss"])) and torch.equal(dead, before)
        assert {int(st["step"]) for st in state.optimizer.state.values()} == {2}
        assert len(state.optimizer.state) == len(list(model.parameters()))
        CheckpointManager(str(tmp_path), "convtasnet").save(state, optimizer)


def test_checkpoints_round_trip(tmp_path):
    """A TDCN: its .pt back through load_checkpoint_model, a port TrainState
    restored by JAX's CheckpointManager and the reverse."""
    model_type, hp, _ = CASES["tdcn"]
    jmodel, params, x = _jax_case("tdcn")
    assert_checkpoints_round_trip(tmp_path, model_type, hp, jmodel, params, _port("tdcn"), x)
