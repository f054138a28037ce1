"""The port's GroupComm SuDoRM-RF v2 against the JAX package, on the CPU.

Toy hparams as in tests/test_pallas_uconv.py (out 32, in 64, group 4, depth
3, basis 24, T = 661, one block); the multichannel case has the hparams of
tests/test_model_parity.py (2 audio channels). Both packages get the
same weights (the JAX init, loaded into the port with
``convert.load_jax_params``) and the same numpy inputs; the JAX serving
forward runs its Pallas kernel in interpret mode. Tolerances: forwards rtol
1e-4, atol 1e-5; grads rtol 1e-4 with atol 1e-4 x the tensor's largest
|grad| (``test_grads_match_jax`` widens it for the scalar PReLU slopes
alone, and says why); a train step's loss rtol
1e-5, as tests/test_torch_train.py holds the Improved model's.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.cli.separate import main as jax_separate_main
from sudo_rm_rf_tpu.inference.overlap_add import OverlapAddSeparator as JaxSeparator
from sudo_rm_rf_tpu.models import fast_inference as jfi
from sudo_rm_rf_tpu.models.groupcomm_sudormrf import TAC as JaxTAC
from sudo_rm_rf_tpu.ops.pallas import uconv as J
from sudo_rm_rf_tpu.parallel import make_mesh
from sudo_rm_rf_tpu.train import trainer as jtrainer
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
from sudo_rm_rf_tpu_torch.config import ModelConfig
from sudo_rm_rf_tpu_torch.convert import load_jax_params
from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import load_pt_file, params_to_state_dict
from sudo_rm_rf_tpu_torch.inference import OverlapAddSeparator
from sudo_rm_rf_tpu_torch.models import fast_inference as tfi
from sudo_rm_rf_tpu_torch.models import groupcomm_sudormrf as tgc
from sudo_rm_rf_tpu_torch.models.groupcomm_sudormrf import TAC
from sudo_rm_rf_tpu_torch.ops import uconv as U
from sudo_rm_rf_tpu_torch.train import trainer as ttrainer
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

HP = dict(in_audio_channels=1, out_channels=32, in_channels=64, num_blocks=1,
          upsampling_depth=3, enc_kernel_size=21, enc_num_basis=24, num_sources=2,
          group_size=4)
STEREO = dict(HP, in_audio_channels=2)
CASES = {"mono": HP, "stereo": STEREO}
LENGTH = 661
TOL = dict(rtol=1e-4, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_case(case, block_impl="xla"):
    """(params as numpy, input, JAX ``apply`` output) of the JAX model. Its
    block forms share one param tree, drawn once per case."""
    hp = CASES[case]
    x = _rand((2, hp["in_audio_channels"], LENGTH), 3)
    model = jmodels.GroupCommSuDORMRF(**hp, block_impl=block_impl)
    if block_impl == "xla":
        params = jax.jit(model.init)(jax.random.key(0), jnp.asarray(x))["params"]
    else:
        params = jax.tree.map(jnp.asarray, _jax_case(case)[0])
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))
    return jax.tree.map(np.asarray, params), x, want


def _port(case="mono", block_impl="xla"):
    return load_jax_params(models.get_model("groupcomm_v2", **CASES[case],
                                            block_impl=block_impl), _jax_case(case)[0])


def _interpret(x, p, depth=5, **kw):
    return J.fused_uconv_block(x, p, depth=depth, interpret=True)


@functools.lru_cache(maxsize=None)
def _jax_fast(case, impl):
    """JAX ``groupcomm_forward_fast`` output; its 'pallas' blocks run in
    interpret mode, as tests/test_pallas_uconv.py runs them."""
    hp = CASES[case]
    params, x, _ = _jax_case(case)
    kw = dict(num_blocks=hp["num_blocks"], upsampling_depth=hp["upsampling_depth"],
              enc_kernel_size=hp["enc_kernel_size"], num_sources=hp["num_sources"],
              group_size=hp["group_size"], in_audio_channels=hp["in_audio_channels"])
    if impl != "pallas":
        return np.asarray(jfi.groupcomm_forward_fast(params, jnp.asarray(x), impl=impl, **kw))
    orig, jfi.fused_uconv_block = jfi.fused_uconv_block, _interpret
    try:
        return np.asarray(jfi.groupcomm_forward_fast.__wrapped__(
            params, jnp.asarray(x), impl="pallas", **kw))
    finally:
        jfi.fused_uconv_block = orig


def _bd_mm(b, g):
    """The port's block-diagonal channel-matmul hook (the arithmetic of
    JAX's 'fma_bd'): the G groups' shared projection ``w`` (O, C) as one
    product with I_G (x) w over v (B*G, C, T) viewed as (B, G*C, T). It holds
    the ``matmuls`` / ``matmul`` hooks, which int8 serving also passes,
    against JAX's own."""

    def bd_mm(w, v):
        o, c = w.shape
        w_bd = torch.kron(torch.eye(g, dtype=w.dtype, device=w.device), w)
        return torch.matmul(w_bd, v.reshape(b, g * c, -1)).reshape(b * g, o, -1)

    return bd_mm


# -- modules ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_tac():
    x = _rand((2, 4, 8, LENGTH), 4)
    tac = JaxTAC(8, 24)
    params = jax.jit(tac.init)(jax.random.key(1), jnp.asarray(x))["params"]
    module = np.asarray(jax.jit(tac.apply)({"params": params}, jnp.asarray(x)))
    fast = np.asarray(jax.jit(jfi._tac_fast)(params, jnp.asarray(x)))
    bd = jfi._make_bd_mm(2, 4)
    fast_bd = np.asarray(jax.jit(lambda p, v: jfi._tac_fast(
        p, v, matmuls=(bd, jfi._einsum_mm, bd)))(params, jnp.asarray(x)))
    return jax.tree.map(np.asarray, params), x, {"module": module, "fast": fast,
                                                 "fast_bd": fast_bd}


@pytest.mark.parametrize("form", ["module", "fast", "fast_bd"])
def test_tac_matches_jax(form):
    params, x, want = _jax_tac()
    tac = load_jax_params(TAC(8, 24), params)
    with torch.no_grad():
        if form == "module":
            got = tac(torch.from_numpy(x))
        else:
            bd = _bd_mm(2, 4)
            mms = (bd, torch.matmul, bd) if form == "fast_bd" else None
            got = tgc._tac_fast(tac, torch.from_numpy(x), matmuls=mms)
    np.testing.assert_allclose(got.numpy(), want[form], **TOL)
    np.testing.assert_allclose(got.numpy(), want["module"], **TOL)


def _block_params(depth, ci, co, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    u = lambda *s: rng.uniform(0.5, 1.5, s).astype(np.float32)
    return dict(proj_w=r(ci, co) * 0.3, proj_b=r(ci) * 0.1, proj_g=u(ci),
                proj_beta=r(ci) * 0.1, proj_slope=np.float32(0.25),
                dw_w=r(depth, ci, 5) * 0.3, dw_b=r(depth, ci) * 0.1, dw_g=u(depth, ci),
                dw_beta=r(depth, ci) * 0.1, final_g=u(ci), final_beta=r(ci) * 0.1,
                final_slope=np.float32(0.25), res_w=r(co, ci) * 0.3, res_b=r(co) * 0.1)


@pytest.mark.parametrize("matmul", ["einsum", "block_diagonal"])
def test_gc_uconv_block_fma_merged_matches_jax(matmul):
    """Merged groups, with and without the block-diagonal products, against
    JAX's, and against the plain block on the folded (B*G, C/G, T) layout."""
    b, g, depth, t = 2, 4, 3, 660
    kp = _block_params(depth, 16, 8, seed=5)
    x = _rand((b, g * 8, t), 6)
    jmm = jfi._make_bd_mm(b, g) if matmul == "block_diagonal" else None
    want = np.asarray(jax.jit(lambda v, p: jfi.gc_uconv_block_fma_merged(v, p, depth, g, matmul=jmm))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in kp.items()}))
    tkp = {k: torch.from_numpy(np.asarray(v)) for k, v in kp.items()}
    tmm = _bd_mm(b, g) if matmul == "block_diagonal" else None
    got = tgc.gc_uconv_block_fma_merged(torch.from_numpy(x), tkp, depth, g, matmul=tmm)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    folded = U.uconv_block_reference(torch.from_numpy(x).reshape(b * g, 8, t), tkp, depth)
    np.testing.assert_allclose(got.numpy(), folded.reshape(b, g * 8, t).numpy(), **TOL)


@functools.lru_cache(maxsize=None)
def _folded_case():
    """Block params and the TAC output of a (2, 4 groups, 8, 336) input,
    with the JAX kernel's (interpret mode) output on its folded view."""
    kp = _block_params(3, 16, 8, seed=7)
    params, _, _ = _jax_tac()
    x = _rand((2, 4, 8, 336), 8)
    y = np.asarray(jfi._tac_fast(params, jnp.asarray(x))).reshape(8, 8, 336)
    want = np.asarray(J.fused_uconv_block(
        jnp.asarray(y), {k: jnp.asarray(v) for k, v in kp.items()}, depth=3, interpret=True))
    return kp, params, x, want


@pytest.mark.parametrize("form", ["levelwise", "fused_uconv_block"])
def test_folded_kernel_route_matches_jax_interpret(form):
    """K1's route at a group-folded shape: the TAC output reshaped to
    (B*G, C/G, T) is a contiguous view (no copy before the kernel), and the
    kernel's CPU decomposition and its wrapper's plain version agree with
    the JAX kernel run in interpret mode."""
    kp, params, x, want = _folded_case()
    tac = load_jax_params(TAC(8, 24), params)
    with torch.no_grad():
        y = tgc._tac_fast(tac, torch.from_numpy(x))
    folded = y.reshape(8, 8, 336)
    assert folded.is_contiguous() and folded.data_ptr() == y.data_ptr()
    tkp = {k: torch.from_numpy(np.asarray(v)) for k, v in kp.items()}
    fn = U.uconv_block_levelwise if form == "levelwise" else U.fused_uconv_block
    np.testing.assert_allclose(fn(folded, tkp, 3).numpy(), want, **TOL)


@pytest.mark.parametrize("block_impl", ["xla", "fma", "kernel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_model_forward_matches_jax(case, block_impl):
    """The port's model in each block form against JAX ``apply`` (its fma
    form against JAX's fma form); a JAX param tree loads strictly."""
    _, x, want = _jax_case(case, "fma" if block_impl == "fma" else "xla")
    model = _port(case, block_impl)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    n_out = CASES[case]["num_sources"] * CASES[case]["in_audio_channels"]
    assert got.shape == want.shape == (2, n_out, LENGTH)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl,case", [(impl, "mono") for impl in tfi.GC_IMPLS]
                         + [("fma_merged", "stereo"), ("xla", "stereo")])
def test_groupcomm_forward_fast_matches_jax(impl, case):
    want = _jax_fast(case, "pallas" if impl == "kernel" else impl)
    got = tfi.groupcomm_forward_fast(_port(case), torch.from_numpy(_jax_case(case)[1]),
                                     impl=impl).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _jax_case(case)[2], **TOL)


# JAX's TPU kernel impl, and the two forms the port does not serve
@pytest.mark.parametrize("unknown", ["pallas", "fma_bd", "fma"])
def test_groupcomm_forward_fast_defaults_and_rejects_unknown_impl(unknown):
    model, x = _port(), torch.from_numpy(_jax_case("mono")[1])
    before = U.fused_uconv_block.launches
    torch.testing.assert_close(tfi.groupcomm_forward_fast(model, x),
                               tfi.groupcomm_forward_fast(model, x, impl="fma_merged"))
    assert U.fused_uconv_block.launches == before
    with pytest.raises(ValueError, match="impl.*'kernel', 'fma_merged', 'xla'"):
        tfi.groupcomm_forward_fast(model, x, impl=unknown)


# -- gradients and training ---------------------------------------------------


# the scalar PReLU slopes of the toy model: TAC's three, the block's two, the mask's
PRELU_SLOPES = ("sm.0.TAC.TAC_input.1.weight", "sm.0.TAC.TAC_mean.1.weight",
                "sm.0.TAC.TAC_output.1.weight", "sm.0.UBlock.proj_1x1.act.weight",
                "sm.0.UBlock.final_norm.act.weight", "mask_net.0.weight")


def _assert_grads_close(got: dict, want_tree, keys, slopes_at_model_scale=False):
    """rtol 1e-4; atol 1e-4 x the tensor's largest |grad|. With
    ``slopes_at_model_scale``, the PRELU_SLOPES (and only they) get atol
    1e-4 x the model's largest |grad|."""
    want = {k: v.numpy() for k, v in params_to_state_dict(want_tree, keys).items()}
    assert sorted(got) == sorted(want)
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        model_scale = slopes_at_model_scale and name in PRELU_SLOPES
        assert not model_scale or w.size == 1, name
        np.testing.assert_allclose(got[name], w, rtol=1e-4,
                                   atol=1e-4 * (top if model_scale else np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("block_impl", ["fma", "xla"])
def test_grads_match_jax(block_impl):
    """d/dparams of sum(out * r) through the port's blocks and jax.grad,
    each tensor within rtol 1e-4 and atol 1e-4 x its own largest |grad|. A
    scalar PReLU slope's gradient here is a sum over every activation that
    cancels to ~1e-3 of the largest gradient, so the six slopes alone get
    atol 1e-4 x the model's largest |grad| (the fp32 rounding of the
    one-pass statistics differs between the two packages)."""
    params, x, _ = _jax_case("mono")
    r = _rand((2, 2, LENGTH), 9)
    jmodel = jmodels.GroupCommSuDORMRF(**HP, block_impl=block_impl)
    jgrads = jax.jit(jax.grad(
        lambda p: jnp.sum(jmodel.apply({"params": p}, jnp.asarray(x)) * r)))(params)
    model = _port("mono", block_impl)
    (model(torch.from_numpy(x)) * torch.from_numpy(r)).sum().backward()
    _assert_grads_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                        jax.tree.map(np.asarray, jgrads), model.state_dict().keys(),
                        slopes_at_model_scale=True)


def _sources(seed, b=4, s=2, t=1000):
    """Brown-noise sources: the toy model's loss sits well inside the clamp."""
    v = np.cumsum(np.random.default_rng(seed).standard_normal((b, s, t)), axis=-1)
    return (v / v.std(axis=-1, keepdims=True)).astype(np.float32)


def _jax_draws(key, b, s):
    """The permutations the JAX ``online_remix_sources`` draws from ``key``."""
    k_slot, *k_batch = jax.random.split(key, s + 1)
    slot = np.array(jax.random.permutation(k_slot, s))
    perms = np.stack([np.array(jax.random.permutation(k, b)) for k in k_batch])
    return torch.from_numpy(slot), torch.from_numpy(perms)


def test_train_step_with_mixture_consistency_matches_jax():
    """One WHAM-recipe step of the fma GroupComm model with the uniform
    projection: loss and every grad against ``jax.value_and_grad`` of the
    JAX trainer's own batch, forward and loss; the grad norm against theirs."""
    cfg = dict(loss_clamp=30.0, mixture_consistency="uniform")
    batch, key = _sources(11), jax.random.key(4)
    params = jax.tree.map(jnp.asarray, _jax_case("mono")[0])
    jt = jtrainer.Trainer(jmodels.GroupCommSuDORMRF(**HP, block_impl="fma"),
                          jtrainer.TrainerConfig(**cfg), mesh=make_mesh(devices=jax.devices()[:1]))
    mixture, targets = jt.prepare_batch(key, jnp.asarray(batch))
    loss_of = lambda p: jnp.clip(jt.loss_fn(jt._forward(p, mixture), targets), -30.0, 30.0)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(params)
    assert abs(float(jloss)) < 30.0  # the clamp is inactive: real gradients

    tr = ttrainer.Trainer(_port("mono", "fma"), ttrainer.TrainerConfig(**cfg))
    state = tr.init_state()
    loss = tr.compute_gradients(state, batch, _jax_draws(key, 4, 2))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_grads_close({n: p.grad.numpy() for n, p in tr.model.named_parameters()},
                        jax.tree.map(np.asarray, jgrads), tr.model.state_dict().keys())
    np.testing.assert_allclose(float(tr.apply_gradients(state)),
                               float(optax.global_norm(jgrads)), rtol=1e-4)


def test_trainer_rejects_the_forward_only_kernel_blocks():
    with pytest.raises(ValueError, match="forward-only"):
        ttrainer.Trainer(models.get_model("groupcomm_v2", **HP, block_impl="kernel"))


# -- serving ------------------------------------------------------------------


def _mixture(n, seed):
    t = np.arange(n) / 8000.0
    return (0.3 * np.sin(2 * np.pi * 300 * t) + 0.2 * np.sin(2 * np.pi * 1700 * t)
            + 0.05 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("weights", ["uniform", "magsq"])
def test_overlap_add_separator_with_mixture_consistency_matches_jax(weights):
    """A ~3.5-chunk mixture in batches of 4 chunks, each chunk's estimates
    projected onto its mixture."""
    chunk = 1600
    params = _jax_case("mono")[0]
    mix = _mixture(int(3.5 * chunk), 1)
    want = JaxSeparator(jmodels.GroupCommSuDORMRF(**HP), jax.tree.map(jnp.asarray, params),
                        chunk_samples=chunk, batch_chunks=4,
                        mixture_consistency=weights).separate(mix)
    model = _port()
    got = OverlapAddSeparator(model, chunk, batch_chunks=4, mixture_consistency=weights,
                              forward_fn=functools.partial(tfi.groupcomm_forward_fast,
                                                           model)).separate(mix)
    assert got.shape == want.shape == (2, mix.size)
    np.testing.assert_allclose(got, want, **TOL)


def test_separate_cli_matches_jax_cli(tmp_path):
    """A bare GroupComm state_dict and a wav through both CLIs with the
    uniform projection (0.4 s chunks, batches of 2): int16 within 1 LSB."""
    model = models.get_model("groupcomm_v2", **HP, generator=torch.Generator().manual_seed(3))
    ckpt, wav = str(tmp_path / "gc.pt"), str(tmp_path / "mix.wav")
    torch.save(model.state_dict(), ckpt)
    wavfile.write(wav, 8000, (_mixture(10400, 2) * 32767).astype(np.int16))
    common = ["--checkpoint", ckpt, "--model_type", "groupcomm_v2", "--input", wav,
              "--chunk_seconds", "0.4", "--batch_chunks", "2",
              "--mixture_consistency", "uniform"]
    for key in ("out_channels", "in_channels", "num_blocks", "upsampling_depth",
                "enc_kernel_size", "enc_num_basis", "group_size"):
        common += [f"--{key}", str(HP[key])]
    assert jax_separate_main(common + ["--out_dir", str(tmp_path / "jax")]) == 0
    before = U.fused_uconv_block.launches
    assert separate_main(common + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert U.fused_uconv_block.launches == before  # the CPU runs no kernel
    for s in (1, 2):
        _, want = wavfile.read(os.path.join(tmp_path, "jax", f"mix_s{s}.wav"))
        _, got = wavfile.read(os.path.join(tmp_path, "port", f"mix_s{s}.wav"))
        assert got.shape == want.shape == (10400,) and got.dtype == np.int16
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_train_cli_groupcomm_one_epoch_cpu(tmp_path, capsys):
    from sudo_rm_rf_tpu_torch.cli.train import main
    from sudo_rm_rf_tpu_torch.data.synthetic import write_wham_corpus

    wham = write_wham_corpus(str(tmp_path / "wham"), n_train=4, n_val=2, seconds=0.5, seed=0)
    argv = ["--train", "WHAM", "--val", "WHAM", "--model_type", "groupcomm_v2",
            "--block_impl", "fma", "--mixture_consistency", "uniform",
            "--out_channels", "16", "--in_channels", "32", "--group_size", "4",
            "--num_blocks", "1", "--upsampling_depth", "2", "--enc_num_basis", "16",
            "-bs", "2", "--audio_timelength", "0.5", "--n_jobs", "1", "--n_epochs", "1",
            "--experiment_name", "gc", "-elp", str(tmp_path / "logs"),
            "-clp", str(tmp_path / "ckpt"), "--wham_root", wham,
            "--save_checkpoint_every", "1", "--device", "cpu"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "epoch 1/1" in out and "val_SISDRi=" in out
    from sudo_rm_rf_tpu_torch.convert.flax_checkpoint import read_checkpoint

    blob = read_checkpoint(str(tmp_path / "ckpt" / "gc" / "groupcomm_v2_epoch_1"))
    assert blob["step"] == 2 and "gamma" in blob["params"]["sm_0"]["TAC"]["TAC_norm"]
    losses = np.load(tmp_path / "logs" / "gc" / "tr_loss" / "epoch_1.npy")
    assert losses.shape == (2,) and np.isfinite(losses).all()


# -- registry, config and checkpoints -----------------------------------------


def test_config_builds_groupcomm_and_waiting_types_raise():
    model = ModelConfig(model_type="groupcomm_v2", out_channels=32, in_channels=64,
                        num_blocks=1, upsampling_depth=3, enc_num_basis=24, group_size=4,
                        in_audio_channels=2, block_impl="xla").build()
    assert (model.group_size, model.in_audio_channels) == (4, 2)
    assert model.sm[0].block_impl == "xla" and model.decoder.weight.shape == (96, 4, 21)
    # the config holds the SuDoRM-RF hparams only: it refuses the baselines,
    # as the JAX package's cannot build them (ROADMAP queue 3); remat_blocks
    # is taken
    with pytest.raises(ValueError, match="ROADMAP queue 3"):
        ModelConfig(model_type="dprnn").build()
    with pytest.raises(ValueError, match="ROADMAP queue 3"):
        ModelConfig(model_type="sepformer").build()
    assert models.get_model("groupcomm_v2", **HP, remat_blocks=True).remat_blocks
    with pytest.raises(KeyError):
        models.get_model("rele")


def test_load_pt_file_recovers_groupcomm_hparams(tmp_path):
    model = models.get_model("groupcomm_v2", **STEREO)
    path = str(tmp_path / "gc.pt")
    torch.save(model, path)
    sd, attrs = load_pt_file(path)
    assert attrs["group_size"] == 4 and attrs["in_audio_channels"] == 2
    rebuilt = models.get_model("groupcomm_v2", **attrs)
    rebuilt.load_state_dict(sd, strict=True)
