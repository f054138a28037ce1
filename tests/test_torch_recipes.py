"""The port's WHAMR! and FUSS recipes against the JAX package, on the CPU.

On the port's own synthetic corpora (``data/synthetic.py``): the WHAMR and
FUSS loaders yield the JAX loaders' arrays exactly (augmented crops and
whole recordings too), ``setup`` builds the same generators, the FUSS
augmentation given JAX's draws gives JAX's sources (1e-6), one train step of
each recipe at toy widths from the same weights gives JAX's loss (rtol 1e-5)
and gradients (each tensor rtol 1e-4, atol 1e-4 of its largest |grad|), the
FUSS validation batch gives JAX's per-sample values (1e-4 dB), and
``sudo-torch-train`` runs an epoch of each recipe on the CPU.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu import config as jconfig
from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.data import setup as jsetup
from sudo_rm_rf_tpu.data.fuss import FUSSDataset as JFUSS
from sudo_rm_rf_tpu.data.whamr import WhamRDataset as JWhamR
from sudo_rm_rf_tpu.parallel import make_mesh
from sudo_rm_rf_tpu.train import augment as jaug
from sudo_rm_rf_tpu.train import experiment as jexp
from sudo_rm_rf_tpu.train import trainer as jtrainer
from sudo_rm_rf_tpu_torch import config as tconfig
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.convert import load_jax_params
from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import params_to_state_dict
from sudo_rm_rf_tpu_torch.data import setup as tsetup
from sudo_rm_rf_tpu_torch.data.fuss import FUSSDataset
from sudo_rm_rf_tpu_torch.data.synthetic import write_fuss_corpus, write_whamr_corpus
from sudo_rm_rf_tpu_torch.data.whamr import WhamRDataset
from sudo_rm_rf_tpu_torch.train import augment
from sudo_rm_rf_tpu_torch.train import experiment as texp
from sudo_rm_rf_tpu_torch.train import trainer as ttrainer
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

TOY = dict(out_channels=32, in_channels=64, num_blocks=2, upsampling_depth=3,
           enc_kernel_size=21, enc_num_basis=24)
T = 1000


@pytest.fixture(scope="module")
def whamr_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("whamr"))
    for fs in (8000, 16000):
        write_whamr_corpus(root, n_train=4, n_val=2, n_test=3, seconds=(0.6, 0.75), fs=fs,
                           seed=1)
    return root


@pytest.fixture(scope="module")
def fuss_root(tmp_path_factory):
    return write_fuss_corpus(str(tmp_path_factory.mktemp("fuss")), n_train=6, n_val=4,
                             n_eval=4, seconds=0.6, seed=2)


def _assert_items_equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# -- loaders and setup --------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(task="noisy_reverberant", split="tr", augment=True, timelength=0.5, sample_rate=8000),
    dict(task="noisy", split="tt", augment=False, timelength=0.5, sample_rate=16000),
    dict(task="noisy_reverberant", split="tt", augment=False, timelength=-1.0,
         sample_rate=16000),
])
def test_whamr_dataset_matches_jax(whamr_root, kw):
    kw = dict(kw, root_dirpath=whamr_root, zero_pad=True, min_or_max="min")
    got, want = WhamRDataset(**kw), JWhamR(**kw)
    assert got.file_names == want.file_names and got.time_samples == want.time_samples
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(got)):
            _assert_items_equal(got[i], want[i])


def test_whamr_sources_and_targets_share_the_crop(whamr_root):
    ds = WhamRDataset(root_dirpath=whamr_root, task="noisy", split="tr", augment=True,
                      timelength=0.5, sample_rate=8000, zero_pad=True, min_or_max="min")
    starts = set()
    for epoch in range(4):
        ds.set_epoch(epoch)
        sources, targets = ds[1]
        # the "noisy" task reads the same anechoic wavs as sources and targets
        np.testing.assert_array_equal(sources, targets)
        starts.add(sources[0, :8].tobytes())
    assert len(starts) > 1  # the crop moves with the epoch


@pytest.mark.parametrize("kw", [
    dict(split="train", augment=True, min_num_sources=1, max_num_sources=4, timelength=0.5),
    dict(split="eval", augment=False, min_num_sources=2, max_num_sources=3, timelength=0.5),
    dict(split="validation", augment=False, min_num_sources=4, max_num_sources=4,
         timelength=-1.0),
])
def test_fuss_dataset_matches_jax(fuss_root, kw):
    kw = dict(kw, root_dirpath=fuss_root, sample_rate=16000, zero_pad=True)
    got, want = FUSSDataset(**kw), JFUSS(**kw)
    assert got.source_folder_names == want.source_folder_names
    for epoch in (0, 2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(got)):
            item = got[i]
            _assert_items_equal(item, want[i])
            assert item.shape[0] == kw["max_num_sources"]


@pytest.mark.parametrize("dataset", ["WHAMR", "FUSS"])
def test_setup_matches_jax(whamr_root, fuss_root, dataset):
    hp = dict(tconfig.ExperimentConfig().hparams(), train=[dataset], val=[dataset],
              test=[dataset], train_val=[], batch_size=2, n_jobs=2, audio_timelength=0.5,
              whamr_root=whamr_root, fuss_root=fuss_root, max_num_sources=4,
              separation_task="noisy_reverberant", fs=16000 if dataset == "FUSS" else 8000)
    got, want = tsetup.setup(hp), jsetup.setup(hp)
    assert sorted(k for k, v in got.items() if v) == sorted(k for k, v in want.items() if v)
    if dataset == "FUSS":
        assert "val_1_srcs" in got and "test_4_srcs" in got and got["val"] is None
    for split, gen in got.items():
        if gen is None:
            continue
        assert len(gen) == len(want[split]) and gen.shuffle == want[split].shuffle
        assert gen.drop_last == want[split].drop_last
        for a, b in zip(gen, want[split]):
            _assert_items_equal(a, b)


def test_synthetic_corpora_are_seeded_and_laid_out(tmp_path):
    from scipy.io import wavfile

    a = write_whamr_corpus(str(tmp_path / "a"), 1, 1, 2, seconds=(0.3, 0.45), fs=16000, seed=5)
    b = write_whamr_corpus(str(tmp_path / "b"), 1, 1, 2, seconds=(0.3, 0.45), fs=16000, seed=5)
    tt = os.path.join("wav16k", "min", "tt")
    for d in ("mix_both_reverb", "mix_both_anechoic", "s1_reverb", "s2_reverb",
              "s1_anechoic", "s2_anechoic", "noise"):
        for f, n in (("p00000.wav", 4800), ("p00001.wav", 7200)):
            ra, rb = (wavfile.read(os.path.join(r, tt, d, f)) for r in (a, b))
            assert ra[0] == 16000 and ra[1].shape == (n,)
            np.testing.assert_array_equal(ra[1], rb[1])
    f = write_fuss_corpus(str(tmp_path / "f"), n_train=5, n_val=8, n_eval=4, seconds=0.25)
    for split, n in (("train", 5), ("validation", 8), ("eval", 4)):
        lines = open(os.path.join(f, f"{split}_example_list.txt")).read().split("\n")[:-1]
        assert len(lines) == n
        counts = [len(line.split()) - 1 for line in lines]
        assert all(1 <= c <= 4 for c in counts)
        if split != "train":
            assert counts == [1 + i % 4 for i in range(n)]
        peaks = []
        for path in " ".join(lines).split():
            sr, wav = wavfile.read(os.path.join(f, path))
            assert sr == 16000 and wav.shape == (4000,)
            peaks.append(np.abs(wav).max())
        # a gated family can be silent in so short a clip, not all of them
        assert np.mean(np.array(peaks) > 0) > 0.5


# -- FUSS augmentation --------------------------------------------------------


def _jax_fuss_draws(key, b, s):
    """The draws ``fuss_online_augment`` takes from ``key``."""
    k_gain, k_slot, *k_batch = jax.random.split(key, s + 2)
    gains = np.array(jax.random.uniform(k_gain, (b, s, 1))) + 0.5
    slot = np.array(jax.random.permutation(k_slot, s))
    perms = np.stack([np.array(jax.random.permutation(k, b)) for k in k_batch])
    return (torch.from_numpy(gains.astype(np.float32)), torch.from_numpy(slot),
            torch.from_numpy(perms))


def _jax_pair_draws(key, b, s):
    return torch.from_numpy(np.stack([np.asarray(jax.random.permutation(k, b))
                                      for k in jax.random.split(key, s)]))


def _sources(seed, b=4, s=4, t=T, silent=True):
    x = np.cumsum(np.random.default_rng(seed).standard_normal((b, s, t)), axis=-1)
    x = (x / x.std(axis=-1, keepdims=True)).astype(np.float32)
    if silent:  # FUSS stacks are zero-padded past an example's sources
        x[0, 2:] = 0.0
        x[2, 3] = 0.0
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_fuss_online_augment_and_mixture_match_jax_with_its_draws(seed):
    src = _sources(seed, b=5)
    key = jax.random.key(seed + 10)
    want = jaug.fuss_online_augment(key, jnp.asarray(src))
    got = augment.fuss_online_augment(torch.from_numpy(src), *_jax_fuss_draws(key, 5, 4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(augment.fuss_mixture(got).numpy(),
                               np.asarray(jaug.fuss_mixture(want)), rtol=1e-6, atol=1e-6)


def test_fuss_mixture_stabilizes_the_std_with_1e_9():
    x = np.zeros((1, 2, 50), np.float32)
    x[0, 0, 0] = 1e-9  # std ~1.4e-10: the eps dominates
    got = augment.fuss_mixture(torch.from_numpy(x)).numpy()
    mean, std = x.sum(1).mean(), x.sum(1).std(ddof=1)
    np.testing.assert_allclose(got, (x.sum(1) - mean) / (std + 1e-9), rtol=1e-6)


def test_draw_fuss_and_draw_pair_remix_are_seeded():
    a = augment.draw_fuss(torch.Generator().manual_seed(3), 6, 4)
    b = augment.draw_fuss(torch.Generator().manual_seed(3), 6, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    gains, slot, perms = a
    assert gains.shape == (6, 4, 1) and 0.5 <= gains.min() and gains.max() < 1.5
    assert sorted(slot.tolist()) == [0, 1, 2, 3] and perms.shape == (4, 6)
    assert all(sorted(p.tolist()) == list(range(6)) for p in perms)
    pairs = augment.draw_pair_remix(torch.Generator().manual_seed(0), 5, 3)
    assert pairs.shape == (3, 5) and all(sorted(p.tolist()) == list(range(5)) for p in pairs)


# -- one train step of each recipe --------------------------------------------


def _configs(dataset, n_src, **train):
    data = dict(train=(dataset,), val=(), fs=16000 if dataset == "FUSS" else 8000,
                separation_task="noisy_reverberant")
    model = dict(TOY, num_sources=n_src, block_impl="fma")
    return (jconfig.ExperimentConfig(model=jconfig.ModelConfig(**model),
                                     data=jconfig.DataConfig(**data),
                                     train=jconfig.TrainConfig(**train)),
            tconfig.ExperimentConfig(model=tconfig.ModelConfig(**model),
                                     data=tconfig.DataConfig(**data),
                                     train=tconfig.TrainConfig(**train)))


@functools.lru_cache(maxsize=None)
def _jax_params(n_src):
    model = jmodels.SuDORMRFImproved(**TOY, num_sources=n_src, block_impl="fma")
    params = model.init(jax.random.key(0), jnp.zeros((2, 1, T)))["params"]
    return jax.tree.map(np.asarray, params)


def _step_case(dataset):
    """(JAX loss, JAX grads, port loss, port grads by name, state_dict keys)
    of one step of ``dataset``'s recipe from the same weights, batch and
    draws: the recipes' own mixture consistency and the run configs' clamps
    (WHAMR 50, FUSS off)."""
    n_src, clamp, mc = (4, 0.0, "uniform") if dataset == "FUSS" else (2, 50.0, None)
    jcfg, tcfg = _configs(dataset, n_src, loss_clamp=clamp)
    key = jax.random.key(5)
    if dataset == "FUSS":
        batch = _sources(21)
        jbatch, draws = jnp.asarray(batch), _jax_fuss_draws(key, 4, 4)
    else:
        src = _sources(22, s=3, silent=False)
        tgt = (0.6 * src + 0.4 * _sources(23, s=3, silent=False)).astype(np.float32)
        batch = (src, tgt)
        jbatch, draws = (jnp.asarray(src), jnp.asarray(tgt)), _jax_pair_draws(key, 4, 3)

    prepare, loss_fn = jexp._make_recipe(jcfg)
    jt = jtrainer.Trainer(jmodels.SuDORMRFImproved(**TOY, num_sources=n_src, block_impl="fma"),
                          jtrainer.TrainerConfig(loss_clamp=clamp, mixture_consistency=mc),
                          loss_fn=loss_fn, prepare_batch=prepare,
                          mesh=make_mesh(devices=jax.devices()[:1]))

    def loss_of(p):
        mixture, targets = jt.prepare_batch(key, jbatch)
        loss = jt.loss_fn(jt._forward(p, mixture), targets)
        return jnp.clip(loss, -clamp, clamp) if clamp > 0 else loss

    params = jax.tree.map(jnp.asarray, _jax_params(n_src))
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(params)
    _, jm = jt.train_step(jt.state_from_params(params), jbatch, key)
    np.testing.assert_allclose(float(jm["loss"]), float(jloss), rtol=1e-6)

    recipe = texp.make_recipe(tcfg)
    assert recipe.pairs == (dataset == "WHAMR")
    model = load_jax_params(models.get_model("relu", **TOY, num_sources=n_src, block_impl="fma"),
                            _jax_params(n_src))
    tr = ttrainer.Trainer(model, ttrainer.TrainerConfig(loss_clamp=clamp, mixture_consistency=mc),
                          loss_fn=recipe.loss_fn, prepare_batch=recipe.prepare)
    state = tr.init_state()
    loss = tr.compute_gradients(state, batch, draws)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return float(jloss), jgrads, float(loss), grads, model.state_dict().keys(), float(jm["grad_norm"]), tr, state


@pytest.mark.parametrize("dataset", ["WHAMR", "FUSS"])
def test_recipe_train_step_matches_jax(dataset):
    jloss, jgrads, loss, grads, keys, jnorm, tr, state = _step_case(dataset)
    if dataset == "WHAMR":
        assert abs(jloss) < 50.0  # the clamp is inactive: real gradients
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    want = params_to_state_dict(jgrads, keys)
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(grads[name], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    norm = tr.apply_gradients(state)
    np.testing.assert_allclose(float(norm), jnorm, rtol=1e-4)


def test_make_recipe_draws_fit_the_batch():
    g = torch.Generator().manual_seed(0)
    _, fuss = _configs("FUSS", 4)
    gains, slot, perms = texp.make_recipe(fuss).draw(g, _sources(0, b=3))
    assert gains.shape == (3, 4, 1) and slot.shape == (4,) and perms.shape == (4, 3)
    _, whamr = _configs("WHAMR", 2)
    src = _sources(1, b=3, s=3, silent=False)
    assert texp.make_recipe(whamr).draw(g, (src, src)).shape == (3, 3)
    _, wham = _configs("WHAM", 2)
    slot, perms = texp.make_recipe(wham).draw(g, src[:, :2])
    assert slot.shape == (2,) and perms.shape == (2, 3)


@pytest.mark.parametrize("n_actual", [1, 2, 4])
def test_fuss_val_batch_matches_jax(n_actual):
    params = jax.tree.map(jnp.asarray, _jax_params(4))
    jmodel = jmodels.SuDORMRFImproved(**TOY, num_sources=4, block_impl="fma")
    from sudo_rm_rf_tpu.losses import mixture_consistency as jmc

    def jforward(m):
        return jmc(jmodel.apply({"params": params}, m), m, "uniform")

    batch = _sources(30 + n_actual, b=3, s=n_actual, silent=False)
    want, west, wmix = jexp.fuss_val_batch(jforward, jnp.asarray(batch), n_actual, 4)
    model = load_jax_params(models.get_model("relu", **TOY, num_sources=4), _jax_params(4))
    tr = ttrainer.Trainer(model, ttrainer.TrainerConfig(mixture_consistency="uniform"))
    with torch.no_grad():
        got, est, mix = texp.fuss_val_batch(lambda m: tr.forward(model, m),
                                            torch.from_numpy(batch), n_actual, 4)
    np.testing.assert_allclose(mix.numpy(), np.asarray(wmix), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(est.numpy(), np.asarray(west), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_val_mixture_sums_and_standardizes_a_source_stack():
    stack = _sources(40, b=2, s=3, silent=False)
    got = texp.val_mixture(stack)
    want = np.asarray(jaug.normalize_wav(jnp.asarray(stack).sum(axis=1)))[:, None, :]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert texp.val_mixture(stack[:, 0]).shape == (2, 1, T)


# -- the CLI ------------------------------------------------------------------


def _train_argv(tmp_path, name):
    return ["--out_channels", "16", "--in_channels", "32", "--num_blocks", "1",
            "--upsampling_depth", "2", "--enc_num_basis", "16", "-bs", "2",
            "--audio_timelength", "0.5", "--n_jobs", "1", "--n_epochs", "1",
            "--experiment_name", name, "-elp", str(tmp_path / "logs"),
            "-clp", str(tmp_path / "ckpt"), "--save_checkpoint_every", "1",
            "--device", "cpu"]


def test_cli_train_whamr_one_epoch_cpu(tmp_path, whamr_root, capsys):
    from sudo_rm_rf_tpu_torch.cli.train import main

    argv = ["--train", "WHAMR", "--val", "WHAMR", "--separation_task", "noisy_reverberant",
            "--whamr_root", whamr_root, "--loss_clamp", "50"] + _train_argv(tmp_path, "whamr")
    assert main(argv) == 0
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("epoch 1/1")][0]
    vals = dict(kv.split("=") for kv in line.split(" (")[0].split()[2:])
    assert sorted(vals) == ["tr_loss", "val_SISDRi"]
    assert all(np.isfinite(float(v)) for v in vals.values())
    from sudo_rm_rf_tpu_torch.convert.flax_checkpoint import read_checkpoint

    blob = read_checkpoint(str(tmp_path / "ckpt" / "whamr" / "relu_epoch_1"))
    assert blob["step"] == 2  # 4 train files at batch 2


def test_cli_train_fuss_one_epoch_cpu(tmp_path, fuss_root, capsys):
    from sudo_rm_rf_tpu_torch.cli.train import main

    argv = ["--train", "FUSS", "--val", "FUSS", "--fuss_root", fuss_root, "-fs", "16000",
            "--max_num_sources", "4", "--loss_clamp", "0"] + _train_argv(tmp_path, "fuss")
    assert main(argv) == 0
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("epoch 1/1")][0]
    vals = dict(kv.split("=") for kv in line.split(" (")[0].split()[2:])
    assert sorted(vals) == ["tr_loss", "val_1_srcs_SISDR", "val_2_srcs_SISDRi",
                            "val_3_srcs_SISDRi", "val_4_srcs_SISDRi"]
    assert all(np.isfinite(float(v)) for v in vals.values())
    # the best checkpoint follows the first per-count val metric
    assert any(n.startswith("best_val_1_srcs_SISDR")
               for n in os.listdir(tmp_path / "ckpt" / "fuss"))
