"""The port's MUSDB path against the JAX package, on the CPU.

On small synthetic corpora written by the port's ``write_musdb_corpus`` (and
by hand for stereo): ``MusdbDataset`` yields the JAX loader's arrays exactly
(mono and stereo, predefined and augmented segments across epochs, the
zero-padding of a short track), ``setup`` picks the root by rate as JAX does,
the recipe's ``prepare`` equals JAX's and its fixed-assignment loss JAX's
(1e-5), the fixed-order val SI-SDRi equals JAX's formula (1e-4 dB), one
MUSDB ``Trainer`` step from the same JAX params gives JAX's loss and params
(rtol and atol 1e-4, as tests/test_model_parity.py), ``run_experiment``
trains and validates an epoch, ``write_musdb_corpus`` writes
``scripts/make_synthetic_musdb.py``'s files bit for bit, and
``sudo-torch-separate --num_sources 4`` of a JAX msgpack checkpoint writes
``sudo-tpu-separate``'s four stems within 1 int16 LSB.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from _torch_zoo_parity import jax_init
from sudo_rm_rf_tpu import config as jconfig
from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.data import setup as jsetup
from sudo_rm_rf_tpu.data.musdb import MusdbDataset as JMusdb
from sudo_rm_rf_tpu.losses import functional as jF
from sudo_rm_rf_tpu.parallel import make_mesh
from sudo_rm_rf_tpu.train import experiment as jexp
from sudo_rm_rf_tpu.train import trainer as jtrainer
from sudo_rm_rf_tpu.utils import checkpoint as jcheckpoint
from sudo_rm_rf_tpu_torch import config as tconfig
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.convert import load_jax_params
from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import params_to_state_dict
from sudo_rm_rf_tpu_torch.data import MusdbDataset
from sudo_rm_rf_tpu_torch.data import setup as tsetup
from sudo_rm_rf_tpu_torch.data.synthetic import write_musdb_corpus, write_track
from sudo_rm_rf_tpu_torch.train import experiment as texp
from sudo_rm_rf_tpu_torch.train import trainer as ttrainer
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=2,
          enc_kernel_size=21, enc_num_basis=16, num_sources=4)
SECONDS = 0.5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 train and 2 test tracks of 2.5 s."""
    return write_musdb_corpus(str(tmp_path_factory.mktemp("musdb")), 3, 2, seconds=2.5,
                              seed=4)


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    """2 train tracks of 1.2 s and a 0.3 s one that the 0.5 s segments must
    zero-pad."""
    root = write_musdb_corpus(str(tmp_path_factory.mktemp("mono")), 2, 0, seconds=1.2, seed=6)
    write_track(os.path.join(root, "train", "track099"), np.random.default_rng(9), 8000, 0.3)
    return root


@pytest.fixture(scope="module")
def stereo(tmp_path_factory):
    """Stereo tracks of int16 noise: two train tracks, one shorter than a
    segment, and a test track."""
    root = str(tmp_path_factory.mktemp("stereo"))
    rng = np.random.default_rng(5)
    for split, i, n in (("train", 0, 9000), ("train", 1, 3000), ("test", 0, 9000)):
        d = os.path.join(root, split, f"track{i}")
        os.makedirs(d)
        for name in ("mixture", "drums", "bass", "other", "vocals"):
            wavfile.write(os.path.join(d, f"{name}.wav"), 8000,
                          rng.integers(-8000, 8000, (n, 2)).astype(np.int16))
    return root


# -- the loader and setup -----------------------------------------------------


@pytest.mark.parametrize("channels", ["mono", "stereo"])
@pytest.mark.parametrize("augment", [False, True])
def test_musdb_dataset_matches_jax(mono, stereo, channels, augment):
    root, n_channels = (mono, 1) if channels == "mono" else (stereo, 2)
    kw = dict(root_dirpath=root, split="train", sample_rate=8000, n_channels=n_channels,
              timelength=SECONDS, augment=augment, n_samples=6 if augment else 0, seed=3)
    got, want = MusdbDataset(**kw), JMusdb(**kw)
    assert len(got) == len(want) and got.track_dirs == want.track_dirs
    assert got._predefined == want._predefined
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(got)):
            g, w = got[i], want[i]
            assert g.dtype == np.float32 and g.shape == w.shape == (n_channels, 4, 4000)
            np.testing.assert_array_equal(g, w)
    short = got.track_dirs.index(os.path.join(root, "train",
                                              "track099" if channels == "mono" else "track1"))
    if not augment:  # the short track, zero-padded past its end
        item = got[[i for i, (t, _) in enumerate(got._predefined) if t == short][0]]
        n = 2400 if channels == "mono" else 3000
        assert np.abs(item[..., :n]).max() > 0 and not item[..., n:].any()


def test_setup_dispatches_musdb_by_rate(corpus, stereo, monkeypatch):
    monkeypatch.setenv("SUDO_TPU_MUSDB8K_ROOT", corpus)
    monkeypatch.setenv("SUDO_TPU_MUSDB_ROOT", stereo)
    for fs, root in ((8000, corpus), (16000, stereo)):
        for split in ("train", "val"):
            kw = dict(dataset_name="MUSDB", data_split=split, sample_rate=fs,
                      timelength=SECONDS, n_channels=2)
            got = tsetup.create_loader_for_simple_dataset(**kw)
            want = jsetup.create_loader_for_simple_dataset(**kw)
            assert got.root_path == want.root_path == root
            assert (got.split, got.augment, got.n_channels) == (
                want.split, want.augment, 2)
    hp = dict(tconfig.ExperimentConfig().hparams(), train=["MUSDB"], val=["MUSDB"],
              batch_size=2, audio_timelength=SECONDS, n_train=4)
    got, want = tsetup.setup(hp), jsetup.setup(hp)
    for split in ("train", "val"):
        assert len(got[split]) == len(want[split]) > 0
        for a, b in zip(got[split], want[split]):
            np.testing.assert_array_equal(a, b)


# -- the recipe and its metric ------------------------------------------------


def _configs(**data):
    jc = jconfig.ExperimentConfig(model=jconfig.ModelConfig(num_sources=4),
                                  data=jconfig.DataConfig(train=("MUSDB",), **data))
    tc = tconfig.ExperimentConfig(model=tconfig.ModelConfig(num_sources=4),
                                  data=tconfig.DataConfig(train=("MUSDB",), **data))
    return jc, tc


def _stems(seed, ch, b=2, t=800):
    return np.random.default_rng(seed).standard_normal((b, ch, 4, t)).astype(np.float32)


@pytest.mark.parametrize("ch", [1, 2])
def test_recipe_matches_jax(ch):
    jc, tc = _configs()
    jprep, jloss = jexp._make_recipe(jc)
    recipe = texp.make_recipe(tc)
    batch = _stems(1, ch)
    jmix, jtgt = jprep(jax.random.key(0), jnp.asarray(batch))
    assert recipe.draw(torch.Generator(), batch) is None  # the path draws nothing
    mix, tgt = recipe.prepare(None, torch.from_numpy(batch))
    np.testing.assert_allclose(mix.numpy(), np.asarray(jmix), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), rtol=1e-6, atol=1e-6)
    est = tgt + torch.from_numpy(_stems(2, 1)[:, 0]) * 0.5
    want = float(jloss(jnp.asarray(est.numpy()), jtgt))
    np.testing.assert_allclose(float(recipe.loss_fn(est, tgt)), want, rtol=1e-5)
    # fixed assignment: the slots carry the stems' identities
    swapped = est[:, [1, 0, 2, 3]]
    assert float(recipe.loss_fn(swapped, tgt)) > want + 1.0


def test_val_sisdri_matches_jax():
    """The fixed-order SI-SDRi against JAX's (``run_experiment``'s MUSDB
    ``sisdri``): per slot SI-SDR minus the mixture's, averaged over slots."""
    tgt = _stems(3, 1)[:, 0]
    est = tgt + _stems(4, 1)[:, 0] * 0.3
    mix = tgt.sum(1, keepdims=True)
    want = jnp.mean(jF.sdr(tgt, est, si=True)
                    - jF.sdr(tgt, jnp.broadcast_to(mix, tgt.shape), si=True), axis=-1)
    got = texp.fixed_order_sisdri(*(torch.from_numpy(a) for a in (est, tgt, mix)))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


# -- the slice as a whole -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax_init(jmodels.get_model("relu", **HP), np.zeros((2, 1, 4000), np.float32))


def _by_name(tree, keys):
    return {k: v.numpy() for k, v in params_to_state_dict(
        jax.tree.map(np.asarray, tree), keys).items()}


def test_musdb_train_step_matches_jax(corpus):
    """One fixed-assignment step of each package from the same params on a
    batch of the MUSDB loader: loss and params after the Adam update within
    rtol and atol 1e-4. The clamp is off, so the loss is the recipe's."""
    ds = MusdbDataset(root_dirpath=corpus, split="train", sample_rate=8000, n_channels=1,
                      timelength=SECONDS, augment=True, n_samples=2)
    batch = np.stack([ds[i] for i in range(2)])
    jc, tc = _configs()
    jprep, jloss = jexp._make_recipe(jc)
    jt = jtrainer.Trainer(jmodels.get_model("relu", **HP), jtrainer.TrainerConfig(loss_clamp=0.0),
                          loss_fn=jloss, prepare_batch=jprep,
                          mesh=make_mesh(devices=jax.devices()[:1]))
    jstate, jm = jt.train_step(jt.state_from_params(jax.tree.map(jnp.asarray, _jax_params())),
                               batch, jax.random.key(0))
    recipe = texp.make_recipe(tc)
    tr = ttrainer.Trainer(load_jax_params(models.get_model("relu", **HP), _jax_params()),
                          ttrainer.TrainerConfig(loss_clamp=0.0), loss_fn=recipe.loss_fn,
                          prepare_batch=recipe.prepare)
    state, m = tr.train_step(tr.init_state(), batch, recipe.draw(None, batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    want = _by_name(jstate.params, state.model.state_dict().keys())
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].reshape(p.shape), rtol=1e-4,
                                   atol=1e-4, err_msg=n)


def test_run_experiment_trains_and_validates_musdb(corpus, tmp_path, monkeypatch):
    from sudo_rm_rf_tpu_torch.cli.args import args_to_config, build_parser
    from sudo_rm_rf_tpu_torch.utils import ExperimentLogger

    monkeypatch.setenv("SUDO_TPU_MUSDB8K_ROOT", corpus)
    # 1.2 s segments: longer than a vocal rest, so no target is silent
    argv = ["--train", "MUSDB", "--val", "MUSDB", "-bs", "2", "--n_train", "4",
            "--audio_timelength", "1.2", "--n_epochs", "1", "--n_jobs", "1",
            "--block_impl", "xla", "-clp", str(tmp_path / "ckpt"), "--loss_clamp", "0",
            *[a for k, v in HP.items() if k != "num_sources" for a in (f"--{k}", str(v))]]
    config = args_to_config(build_parser().parse_args(argv))
    assert config.model.num_sources == 4
    logger = ExperimentLogger(str(tmp_path / "logs"), "musdb")
    state, history = texp.run_experiment(config, logger=logger, device="cpu")
    logger.close()
    assert state.step == 2 and list(history[0]) == ["tr_loss", "val_SISDRi"]
    assert all(np.isfinite(v) for v in history[0].values())


# -- the corpus writer and serving --------------------------------------------


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_musdb_corpus_matches_the_script(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    _script("make_synthetic_musdb").main(
        ["--out", str(tmp_path / "script"), "--train_tracks", "2", "--test_tracks", "1",
         "--seconds", "2.5", "--seed", "7"])
    write_musdb_corpus(str(tmp_path / "port"), 2, 1, seconds=2.5, seed=7)
    names = []
    for dirpath, _, files in os.walk(tmp_path / "script"):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), tmp_path / "script")
            with open(tmp_path / "script" / rel, "rb") as a, open(tmp_path / "port" / rel, "rb") as b:
                assert a.read() == b.read(), rel
            names.append(rel)
    assert len(names) == 3 * 5


def test_separate_four_stems_matches_jax_cli(tmp_path, corpus):
    from sudo_rm_rf_tpu.cli.separate import main as jax_main
    from sudo_rm_rf_tpu_torch.cli.separate import main

    ckpt = jcheckpoint.CheckpointManager(str(tmp_path / "ckpt"), "relu").save(
        jax.tree.map(jnp.asarray, _jax_params()), "params")
    wav = os.path.join(corpus, "test", "track000", "mixture.wav")
    common = ["--checkpoint", ckpt, "--input", wav, "--chunk_seconds", "0.4",
              "--batch_chunks", "2", "--num_sources", "4",
              *[a for k, v in HP.items() if k != "num_sources" for a in (f"--{k}", str(v))]]
    assert jax_main(common + ["--out_dir", str(tmp_path / "jax")]) == 0
    assert main(common + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    for s in range(1, 5):
        _, want = wavfile.read(tmp_path / "jax" / f"mixture_s{s}.wav")
        _, got = wavfile.read(tmp_path / "port" / f"mixture_s{s}.wav")
        assert got.shape == want.shape == (20000,) and got.dtype == np.int16
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
