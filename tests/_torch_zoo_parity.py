"""Shared parity checks of the port's causal, v1, attentive and baseline
models against the JAX package, on the CPU (used by
tests/test_torch_causal.py, tests/test_torch_sudormrf_v1.py,
tests/test_torch_attentive.py, tests/test_torch_baselines.py and
tests/test_torch_sepformer.py).

Each check takes a JAX flax module, its params (numpy) and the port's model
with those params loaded by ``convert.load_jax_params``. Tolerances: forward
rtol 1e-4, atol 1e-5; grads rtol 1e-4 with atol 1e-4 x the tensor's largest
|grad|; a train step's loss rtol 1e-5 and its grad norm rtol 1e-4; the CLIs'
int16 within 1 LSB; msgpack round trips exact.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy.io import wavfile

from sudo_rm_rf_tpu import losses as jlosses
from sudo_rm_rf_tpu.cli.separate import main as jax_separate_main
from sudo_rm_rf_tpu.parallel import make_mesh
from sudo_rm_rf_tpu.train import trainer as jtrainer
from sudo_rm_rf_tpu.utils import checkpoint as jcheckpoint
from sudo_rm_rf_tpu_torch import losses as tlosses
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
from sudo_rm_rf_tpu_torch.convert.flax_checkpoint import read_checkpoint
from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import params_to_state_dict
from sudo_rm_rf_tpu_torch.train import trainer as ttrainer
from sudo_rm_rf_tpu_torch.utils import CheckpointManager

TOL = dict(rtol=1e-4, atol=1e-5)
CLAMP = 30.0
HP_FLAGS = ("out_channels", "in_channels", "num_blocks", "upsampling_depth",
            "enc_kernel_size", "enc_num_basis", "num_sources")


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def brown_sources(seed, b, s, t):
    """Brown-noise sources: a toy model's loss sits well inside the clamp on
    them."""
    x = np.cumsum(np.random.default_rng(seed).standard_normal((b, s, t)), axis=-1)
    return (x / x.std(axis=-1, keepdims=True)).astype(np.float32)


def jax_init(jmodel, x, seed=0):
    params = jax.jit(jmodel.init)(jax.random.key(seed), jnp.asarray(x))["params"]
    return jax.tree.map(np.asarray, params)


def jax_forward(jmodel, params, x):
    return np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))


def assert_forward_matches(jmodel, params, port, x):
    want = jax_forward(jmodel, params, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def _assert_grads_close(port, want_tree, zero_grads=()):
    """Each grad tensor within rtol 1e-4, atol 1e-4 x its largest |grad|.
    A key projection's bias (``K_proj.bias``) has an exactly zero gradient:
    it adds one constant to every logit of a query, which the softmax over
    the keys removes. Both packages' grads there are rounding noise, held to
    <= 1e-6 x the largest |grad| of the model. The output layer's bias
    (``zero_grads``) adds a constant to each estimate, which the zero-mean
    SI-SDR removes: its exact gradient is 0 too, but it sums the loss's
    gradient over every output sample, so float32 leaves up to ~3e-4 of the
    largest |grad| (a toy Demucs); it is held to <= 1e-3 x the largest |grad|
    in both packages. A param the loss does not
    reach (ConvTasNet's last residual conv) has no ``.grad`` in torch and a
    zero one in JAX: it is held as zeros."""
    want = params_to_state_dict(jax.tree.map(np.asarray, want_tree),
                                port.state_dict().keys())
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, w in want.items():
        w = w.reshape(got[name].shape).numpy()
        if name.endswith("K_proj.bias"):
            assert max(np.abs(w).max(), got[name].abs().max().item()) <= 1e-6 * scale, name
            continue
        if name in zero_grads:
            assert max(np.abs(w).max(), got[name].abs().max().item()) <= 1e-3 * scale, name
            continue
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def assert_grads_match(jmodel, params, port, x, seed=11):
    """Grads of sum(out * r) for a fixed random r, against
    ``jax.value_and_grad``; returns the port's grads by name."""
    out_shape = jax.eval_shape(lambda p: jmodel.apply({"params": p}, jnp.asarray(x)),
                               params).shape
    r = rand(out_shape, seed)

    def loss(p):
        return jnp.sum(jmodel.apply({"params": p}, jnp.asarray(x)) * r)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jax.tree.map(jnp.asarray, params))
    port.zero_grad(set_to_none=True)
    tloss = (port(torch.from_numpy(x)) * torch.from_numpy(r)).sum()
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-4)
    _assert_grads_close(port, jgrads)
    return {n: p.grad.clone() for n, p in port.named_parameters()}


def assert_pit_grads_match(jmodel, params, port, x, targets, zero_grads=()):
    """Grads of the PIT negative SI-SDR of the estimates against
    ``targets`` (B, S, T), against ``jax.value_and_grad`` of JAX's loss:
    the loss within rtol 1e-5, each grad as :func:`_assert_grads_close`."""
    def loss(p):
        est = jmodel.apply({"params": p}, jnp.asarray(x))
        return jlosses.pit_neg_sdr_loss(est, jnp.asarray(targets))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jax.tree.map(jnp.asarray, params))
    port.zero_grad(set_to_none=True)
    tloss = tlosses.pit_neg_sdr_loss(port(torch.from_numpy(x)), torch.from_numpy(targets))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    _assert_grads_close(port, jgrads, zero_grads)


def jax_draws(key, b, s):
    """The permutations JAX's ``online_remix_sources`` draws from ``key``."""
    k_slot, *k_batch = jax.random.split(key, s + 1)
    slot = np.array(jax.random.permutation(k_slot, s))
    perms = np.stack([np.array(jax.random.permutation(k, b)) for k in k_batch])
    return torch.from_numpy(slot), torch.from_numpy(perms)


def assert_train_step_matches(jmodel, params, port, batch, seed=3, **cfg):
    """One step of JAX's Trainer and the port's from the same params, batch
    and remix draws, dropout off: loss rtol 1e-5, grad norm rtol 1e-4. The
    clamp (CLAMP unless ``cfg`` says) must be inactive, or the grads would
    be zeros."""
    cfg = {"loss_clamp": CLAMP, **cfg}
    jt = jtrainer.Trainer(jmodel, jtrainer.TrainerConfig(**cfg),
                          mesh=make_mesh(devices=jax.devices()[:1]))
    key = jax.random.key(seed)
    _, jm = jt.train_step(jt.state_from_params(jax.tree.map(jnp.asarray, params)),
                          jnp.asarray(batch), key)
    tr = ttrainer.Trainer(port, ttrainer.TrainerConfig(**cfg))
    _, m = tr.train_step(tr.init_state(), batch, jax_draws(key, *batch.shape[:2]))
    assert cfg["loss_clamp"] == 0 or abs(float(jm["loss"])) < cfg["loss_clamp"]
    assert float(jm["grad_norm"]) > 0
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)


def hp_argv(hp):
    return [a for k in HP_FLAGS if k in hp for a in (f"--{k}", str(hp[k]))]


def assert_separate_cli_matches_jax(tmp_path, model_type, hp, port, n=10400):
    """A bare state_dict of ``port`` and a wav through both CLIs (0.4 s
    chunks, batches of 2): int16 within 1 LSB. Also the same weights as a
    msgpack checkpoint through the port's CLI: identical int16."""
    from sudo_rm_rf_tpu_torch.convert.flax_checkpoint import train_state_to_flax
    from sudo_rm_rf_tpu_torch.convert import msgpack_format

    ckpt, wav = str(tmp_path / "m.pt"), str(tmp_path / "mix.wav")
    torch.save(port.state_dict(), ckpt)
    mix = np.cumsum(np.random.default_rng(5).standard_normal(n))
    wavfile.write(wav, 8000, (0.5 * mix / np.abs(mix).max() * 32767).astype(np.int16))
    common = ["--model_type", model_type, "--input", wav, "--chunk_seconds", "0.4",
              "--batch_chunks", "2", *hp_argv(hp)]
    assert jax_separate_main(["--checkpoint", ckpt, *common,
                              "--out_dir", str(tmp_path / "jax")]) == 0
    assert separate_main(["--checkpoint", ckpt, *common, "--out_dir", str(tmp_path / "port"),
                          "--device", "cpu"]) == 0
    state = ttrainer.Trainer(port).init_state()
    msgpack = str(tmp_path / "m_msgpack")
    with open(msgpack, "wb") as fh:
        fh.write(msgpack_format.packb(train_state_to_flax(state)))
    assert separate_main(["--checkpoint", msgpack, *common,
                          "--out_dir", str(tmp_path / "port_msgpack"), "--device", "cpu"]) == 0
    for s in range(1, hp.get("num_sources", 2) + 1):
        _, want = wavfile.read(os.path.join(tmp_path, "jax", f"mix_s{s}.wav"))
        _, got = wavfile.read(os.path.join(tmp_path, "port", f"mix_s{s}.wav"))
        _, got_mp = wavfile.read(os.path.join(tmp_path, "port_msgpack", f"mix_s{s}.wav"))
        assert got.shape == want.shape == (n,) and got.dtype == np.int16
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        np.testing.assert_array_equal(got_mp, got)


def assert_checkpoints_round_trip(tmp_path, model_type, hp, jmodel, params, port, x):
    """The port's ``.pt`` back through ``models.load_checkpoint_model``; a
    port TrainState after one step restored by JAX's CheckpointManager (every
    path, shape and dtype of JAX's own state, the same params, JAX's forward
    of them equal to the port's); a JAX TrainState restored by the port's
    CheckpointManager (params exact)."""
    pt = str(tmp_path / "m.pt")
    torch.save(port.state_dict(), pt)
    back = models.load_checkpoint_model(model_type, hp, pt, "cpu")
    for (k, a), (k2, b) in zip(port.state_dict().items(), back.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k

    b, s = 2, hp.get("num_sources", 2)
    batch = brown_sources(40, b, s, x.shape[-1])
    tr = ttrainer.Trainer(port, ttrainer.TrainerConfig(loss_clamp=CLAMP))
    state, _ = tr.train_step(tr.init_state(), batch, jax_draws(jax.random.key(1), b, s))
    CheckpointManager(str(tmp_path / "port"), model_type).save(state, "e1")
    jt = jtrainer.Trainer(jmodel, jtrainer.TrainerConfig(loss_clamp=CLAMP),
                          mesh=make_mesh(devices=jax.devices()[:1]))
    template = jt.state_from_params(jax.tree.map(jnp.asarray, params))
    flat = lambda tree: {jax.tree_util.keystr(k): (np.shape(v), np.asarray(v).dtype)
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    written = read_checkpoint(str(tmp_path / "port" / "e1"))
    assert flat(written) == flat(flax.serialization.to_state_dict(template))
    got = jcheckpoint.CheckpointManager(str(tmp_path / "port"), model_type).restore(
        template, "e1")
    assert int(got.step) == 1
    with torch.no_grad():
        out = state.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, jax_forward(jmodel, got.params, x), rtol=1e-4, atol=1e-4)

    jcheckpoint.CheckpointManager(str(tmp_path / "jax"), model_type).save(template, "e0")
    restored = CheckpointManager(str(tmp_path / "jax"), model_type).restore(
        ttrainer.Trainer(models.get_model(model_type, **hp)).init_state(), "e0")
    want = params_to_state_dict(params, restored.model.state_dict().keys())
    for name, p in restored.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].reshape(p.shape).numpy(),
                                      err_msg=name)
