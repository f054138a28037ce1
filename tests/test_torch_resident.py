"""The port's device-resident training data (``train/resident.py``) against
the JAX package's and against its own host loader, on the CPU.

The hierarchical corpus is JAX's test corpus (``tests/test_resident.py``:
two roots with different class and sample counts and utterance lengths), in
brown noise, on which the toy model's loss lies inside the clamp.

Tolerances: ``mix_from_draws`` against the host loader's items rtol 1e-4 with
atol 2e-5 (JAX's own, ``tests/test_resident.py``), against JAX's with the
same draws rtol 1e-5 with atol 1e-6; the resident epoch against the per-step
loop fed the same draws bit for bit; against JAX's ``make_resident_epoch``
fed the draws JAX derives from its key, each step's loss rtol 1e-5 and the
params rtol 1e-4 with atol 1e-4 x the tensor's largest entry
(``tests/test_torch_train.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.data.hierarchical import AugmentedOnlineMixingDataset as JaxDataset
from sudo_rm_rf_tpu.train import resident as jresident
from sudo_rm_rf_tpu.train.trainer import Trainer as JaxTrainer
from sudo_rm_rf_tpu.train.trainer import TrainerConfig as JaxConfig
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.convert import params_to_flax
from sudo_rm_rf_tpu_torch.data.hierarchical import AugmentedOnlineMixingDataset
from sudo_rm_rf_tpu_torch.prep.hierarchical import _dump_sample
from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_remix
from sudo_rm_rf_tpu_torch.train import resident
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

SR = 800
T_SEL = 640  # 0.8 s at 800 Hz
TINY = dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=2,
            enc_kernel_size=9, enc_num_basis=16, num_sources=2)
HOST = dict(rtol=1e-4, atol=2e-5)
CLAMP = 30.0


def _mk_corpus(root, n_classes, n_utts, lengths, seed):
    rng = np.random.default_rng(seed)
    for c in range(n_classes):
        for u in range(n_utts):
            n = lengths[(c * n_utts + u) % len(lengths)]
            wav = np.cumsum(rng.standard_normal(n))
            _dump_sample(os.path.join(root, f"cls{c:02d}", f"utt{u:02d}"),
                         (wav / wav.std()).astype(np.float32))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root_a = _mk_corpus(str(tmp_path_factory.mktemp("hier_a")), 3, 2,
                        [T_SEL, T_SEL + 100, T_SEL + 257], seed=1)
    root_b = _mk_corpus(str(tmp_path_factory.mktemp("hier_b")), 2, 3,
                        [T_SEL + 33, T_SEL], seed=2)
    return [root_a, root_b]


def _kw(corpus, n_samples, fixed_seed):
    return dict(input_dataset_p=corpus, datasets_priors=[0.6, 0.4], n_sources=2,
                n_samples=n_samples, max_abs_snr=2.5, sample_rate=SR,
                selected_timelength=T_SEL / SR, fixed_seed=fixed_seed)


def _pool(corpus, n_samples=24, fixed_seed=7):
    ds = AugmentedOnlineMixingDataset(**_kw(corpus, n_samples, fixed_seed))
    return ds, resident.hierarchical_pool_from_dataset(ds, "cpu")


def test_mix_from_draws_matches_the_host_loader(corpus):
    """The dataset's pre-generated draws through the pool give the host
    loader's items."""
    ds, pool = _pool(corpus)
    mix, src = resident.mix_from_draws(pool.arrays, torch.from_numpy(ds.random_draws),
                                       pool.t_sel, pool.max_abs_snr)
    assert mix.shape == (len(ds), T_SEL) and src.shape == (len(ds), 2, T_SEL)
    for i in range(len(ds)):
        host_mix, host_src = ds[i]
        np.testing.assert_allclose(mix[i].numpy(), host_mix, **HOST, err_msg=f"item {i}")
        np.testing.assert_allclose(src[i].numpy(), host_src, **HOST, err_msg=f"item {i}")


def test_mix_from_draws_matches_jax_with_its_draws(corpus):
    ds, pool = _pool(corpus)
    jpool = jresident.hierarchical_pool_from_dataset(JaxDataset(**_kw(corpus, 24, 7)))
    draws = np.array(jax.random.uniform(jax.random.key(3), (16, 2, 5)))
    jmix, jsrc = jresident.mix_from_draws(jpool.arrays, jnp.asarray(draws), jpool.t_sel,
                                          jpool.max_abs_snr)
    mix, src = resident.mix_from_draws(pool.arrays, torch.from_numpy(draws), pool.t_sel,
                                       pool.max_abs_snr)
    for name, host in (("wavs", np.float32), ("lengths", np.int64),
                       ("class_n_samples", np.int64)):
        np.testing.assert_array_equal(pool.arrays[name].numpy(),
                                      np.asarray(jpool.arrays[name]).astype(host))
    np.testing.assert_allclose(mix.numpy(), np.asarray(jmix), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(src.numpy(), np.asarray(jsrc), rtol=1e-5, atol=1e-6)


def test_mix_from_draws_class_collision(corpus):
    """Draws that put both sources on one (dataset, class) move source 1 to
    class (h + 1) % n, as the host loader does."""
    _, pool = _pool(corpus)
    draws = np.zeros((1, 2, 5), np.float32)
    draws[:, :, 1] = 0.5  # dataset 0 (3 classes), class 1 for both
    draws[:, :, 4] = 0.5  # 0 dB
    _, src = resident.mix_from_draws(pool.arrays, torch.from_numpy(draws), pool.t_sel,
                                     pool.max_abs_snr)
    host = AugmentedOnlineMixingDataset(**_kw(corpus, 1, 3))
    host.random_draws = draws.astype(np.float64)
    np.testing.assert_allclose(src[0].numpy(), host[0][1], **HOST)
    assert not np.allclose(src[0, 0].numpy(), src[0, 1].numpy())


def test_examples_pool_and_sampler():
    """A (sources, targets) pair bank gathers both with one index; a plain
    bank stacks its items; the rows come from the generator's draws."""

    class PairDS:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            src = np.full((2, 32), float(i), np.float32)
            return src, src * 0.5

    pool = resident.examples_pool_from_dataset(PairDS(), device="cpu")
    assert isinstance(pool, tuple) and pool[0].shape == (6, 2, 32)
    sampler = resident.make_examples_sampler(6, batch_size=4)
    idx = sampler.draw(torch.Generator().manual_seed(0))
    assert idx.shape == (4,) and int(idx.min()) >= 0 and int(idx.max()) < 6
    srcs, tgts = sampler.gather(pool, idx)
    np.testing.assert_array_equal(srcs[:, 0, 0].numpy(), idx.numpy().astype(np.float32))
    np.testing.assert_array_equal(tgts.numpy(), srcs.numpy() * 0.5)
    plain = resident.examples_pool_from_dataset(PairDS(), project=lambda it: it[-1],
                                                device="cpu")
    assert plain.shape == (6, 2, 32) and float(plain[5, 0, 0]) == 2.5


def _trainer(**cfg):
    model = models.get_model("relu", **TINY, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, TrainerConfig(learning_rate=1e-3, loss_clamp=CLAMP, **cfg))
    return trainer, trainer.init_state()


def _remix_draw(generator, batch):
    return draw_remix(generator, *batch.shape[:2])


def test_resident_epoch_equals_the_per_step_loop(corpus, monkeypatch):
    """One resident epoch from a seeded generator is, bit for bit, the
    per-step loop that draws its batches and remixes from the same
    generator; read in chunks of SUDO_TPU_RESIDENT_CHUNK it is the same."""
    _, pool = _pool(corpus, n_samples=16, fixed_seed=0)
    sampler = resident.make_hier_sampler(pool, batch_size=4)

    tr_a, st_a = _trainer()
    data = resident.ResidentData(tr_a, sampler, pool.arrays, 5, _remix_draw)
    st_a, losses = data.run_epoch(st_a, torch.Generator().manual_seed(5))
    assert losses.shape == (5,) and st_a.step == 5

    tr_b, st_b = _trainer()
    g = torch.Generator().manual_seed(5)
    loop = []
    for _ in range(5):
        batch = resident.mix_from_draws(pool.arrays, torch.rand((4, 2, 5), generator=g),
                                        pool.t_sel, pool.max_abs_snr)[1]
        st_b, m = tr_b.train_step(st_b, batch, draw_remix(g, 4, 2))
        loop.append(float(m["loss"]))
    assert losses.tolist() == loop and max(abs(v) for v in loop) < CLAMP
    for (name, a), b in zip(tr_a.model.state_dict().items(), tr_b.model.state_dict().values()):
        assert torch.equal(a, b), name

    monkeypatch.setenv("SUDO_TPU_RESIDENT_CHUNK", "2")
    tr_c, st_c = _trainer()
    chunked = resident.ResidentData(tr_c, sampler, pool.arrays, 5, _remix_draw)
    _, chunk_losses = chunked.run_epoch(st_c, torch.Generator().manual_seed(5))
    assert chunk_losses.tolist() == loop


def _jax_remix_draws(key, b, s):
    k_slot, *k_batch = jax.random.split(key, s + 1)
    return (torch.from_numpy(np.array(jax.random.permutation(k_slot, s))),
            torch.from_numpy(np.stack([np.array(jax.random.permutation(k, b))
                                       for k in k_batch])))


def test_resident_epoch_matches_jax_with_its_draws(corpus):
    """JAX's ``make_resident_epoch`` from the port's init, against the
    port's epoch fed the draws JAX derives from its key: each scan step
    splits (key, draw, step), draws (B, S, 5) uniforms from the draw key and
    remixes from the step key."""
    steps, bs = 3, 4
    ds, pool = _pool(corpus, n_samples=16, fixed_seed=0)
    tr, state = _trainer()
    params = params_to_flax(tr.model)
    jtr = JaxTrainer(jmodels.SuDORMRFImproved(**TINY),
                     JaxConfig(learning_rate=1e-3, loss_clamp=CLAMP))
    jpool = jresident.hierarchical_pool_from_dataset(JaxDataset(**_kw(corpus, 16, 0)))
    jepoch = jresident.make_resident_epoch(
        jtr, jresident.make_hier_sampler(jpool, bs), steps)
    jstate, jmetrics, _ = jepoch(jtr.state_from_params(jax.tree.map(jnp.asarray, params)),
                                 jax.random.key(5), jpool.arrays)

    draws, key = [], jax.random.key(5)
    for _ in range(steps):
        key, k_draw, k_step = jax.random.split(key, 3)
        uniforms = torch.from_numpy(np.array(jax.random.uniform(k_draw, (bs, 2, 5))))
        draws.append((uniforms, _jax_remix_draws(k_step, bs, 2)))
    sampler = resident.make_hier_sampler(pool, bs)
    state, losses = resident.ResidentData(tr, sampler, pool.arrays, steps, _remix_draw
                                          ).run_epoch(state, draws=draws)
    jlosses = np.asarray(jmetrics["loss"])
    assert np.abs(jlosses).max() < CLAMP
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5)
    mine = tr.model.state_dict()
    for name, want in _as_state_dict(jstate.params).items():
        np.testing.assert_allclose(mine[name].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)


def _as_state_dict(jparams):
    from sudo_rm_rf_tpu_torch.convert import load_jax_params

    model = models.get_model("relu", **TINY)
    load_jax_params(model, jax.tree.map(np.asarray, jax.device_get(jparams)))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def test_run_experiment_device_data(corpus, tmp_path, capsys):
    """``device_data`` through ``run_experiment`` on an AUGMENTED corpus: the
    pool is built and printed, two resident epochs train and validate (the
    val set mixed from its draws on the device), the checkpoints hold the
    steps."""
    from sudo_rm_rf_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from sudo_rm_rf_tpu_torch.train.experiment import run_experiment
    from sudo_rm_rf_tpu_torch.utils import ExperimentLogger

    cfg = ExperimentConfig(
        model=ModelConfig(model_type="relu", **TINY),
        data=DataConfig(train=("AUGMENTED_WSJMIX",), val=("AUGMENTED_WSJMIX",),
                        train_dataset_paths=tuple(corpus), val_dataset_paths=tuple(corpus),
                        n_train=16, n_val=8, fs=SR, audio_timelength=T_SEL / SR,
                        batch_size=8, n_jobs=1),
        train=TrainConfig(n_epochs=2, learning_rate=1e-3, device_data=True,
                          save_checkpoint_every=1, checkpoints_path=str(tmp_path / "ck")),
        experiment_name="tiny_resident",
    )
    logger = ExperimentLogger(str(tmp_path), "tiny_resident")
    state, history = run_experiment(cfg, logger=logger, device="cpu")
    logger.close()
    out = capsys.readouterr().out
    assert "device-resident pool: " in out and "2 steps/epoch" in out
    assert len(history) == 2 and state.step == 4  # 2 epochs x (16 // 8) steps
    assert all(np.isfinite(h["tr_loss"]) and np.isfinite(h["val_SISDRi"]) for h in history)
