"""The msgpack checkpoint bridge between the packages, on the CPU.

``convert.msgpack_format`` against ``flax.serialization`` both ways (float32
and bfloat16 arrays, numpy int32 scalars, empty maps, tuples saved as maps,
Python scalars, one chunked array); a JAX ``TrainState`` saved by the JAX
``CheckpointManager`` and resumed by the port's, and the reverse; resuming a
JAX run in ``run_experiment``; and the ``.pt`` files of earlier versions of
the port.

Tolerances: round trips exact; one step after a resume in each package:
loss rtol 1e-5, params rtol = atol = 1e-5; JAX's forward with the port's
saved params against the port's forward rtol = atol = 1e-4.
"""

import copy
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.parallel import make_mesh
from sudo_rm_rf_tpu.train import trainer as jtrainer
from sudo_rm_rf_tpu.utils import checkpoint as jcheckpoint
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.convert import load_jax_params, msgpack_format
from sudo_rm_rf_tpu_torch.convert.flax_checkpoint import (
    checkpoint_format,
    read_checkpoint,
    save_train_state,
)
from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import params_to_state_dict
from sudo_rm_rf_tpu_torch.train import trainer as ttrainer
from sudo_rm_rf_tpu_torch.utils import CheckpointManager
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

TOY = dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=2,
           enc_kernel_size=21, enc_num_basis=16, num_sources=2)
B, S, T = 4, 2, 800
CLAMP = 30.0
CFG = dict(loss_clamp=CLAMP, patience_epochs=1, steps_per_epoch=2)


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


_RNG = np.random.default_rng(0)
TREES = {
    "float32": {"w": _RNG.standard_normal((3, 4)).astype(np.float32),
                "b": _RNG.standard_normal(5).astype(np.float32)},
    "bfloat16": {"w": _bf16(_RNG.standard_normal((2, 7))), "x": _bf16(1.5)},
    "int32_scalars": {"step": np.int32(7), "count": np.array(3, np.int32),
                      "neg": np.int32(-40000)},
    "maps": {"empty": {}, "tuple": {"0": {}, "1": {"0": {"count": np.int32(2)},
                                                   "1": {"count": np.int32(2)}}}},
    "python": {"i": [1, -5, 300, -300, 70000, 2**40], "f": 0.25, "s": "x" * 40,
               "none": None, "t": True, "c": 1 + 2j, "long_map": {f"k{i}": i for i in range(20)}},
}


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(got, torch.Tensor):  # a bfloat16 array
        assert got.dtype == torch.bfloat16 and want.dtype.name == "bfloat16"
        assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        if want.dtype.name == "bfloat16":
            assert np.array_equal(got.view(np.int16), want.view(np.int16))
        else:
            assert np.array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("name", sorted(TREES))
def test_unpackb_reads_flax_bytes(name):
    tree = TREES[name]
    blob = flax.serialization.msgpack_serialize(tree, in_place=False)
    _assert_trees_equal(msgpack_format.unpackb(blob), tree)
    _assert_trees_equal(msgpack_format.unpackb(blob), flax.serialization.msgpack_restore(blob))


@pytest.mark.parametrize("name", sorted(TREES))
def test_flax_reads_packb_bytes(name):
    tree = TREES[name]
    _assert_trees_equal(flax.serialization.msgpack_restore(msgpack_format.packb(tree)), tree)
    # the same bytes as flax writes for the tree, its key order kept
    assert msgpack_format.packb(tree) == flax.serialization.msgpack_serialize(
        copy.deepcopy(tree), in_place=True)


def test_chunked_arrays_both_ways(monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 24)
    monkeypatch.setattr(msgpack_format, "MAX_CHUNK_SIZE", 24)
    tree = {"big": np.arange(23, dtype=np.float32).reshape(23, 1),
            "small": {"v": np.arange(3, dtype=np.float32)}}
    theirs = flax.serialization.msgpack_serialize(tree, in_place=False)
    assert b"__msgpack_chunked_array__" in theirs
    assert msgpack_format.packb(tree) == theirs
    _assert_trees_equal(msgpack_format.unpackb(theirs), tree)
    _assert_trees_equal(flax.serialization.msgpack_restore(msgpack_format.packb(tree)), tree)


def test_unpackb_raises_on_what_flax_does_not_write():
    with pytest.raises(ValueError, match="ext type 9"):
        msgpack_format.unpackb(b"\xd4\x09\x00")
    with pytest.raises(TypeError, match="cannot pack set"):
        msgpack_format.packb({"s": {1}})
    with pytest.raises(ValueError, match="ends early"):
        msgpack_format.unpackb(msgpack_format.packb({"a": 1})[:-1])


# -- train states across the packages --------------------------------------------


def _sources(seed):
    x = np.cumsum(np.random.default_rng(seed).standard_normal((B, S, T)), axis=-1)
    return (x / x.std(axis=-1, keepdims=True)).astype(np.float32)


def _jax_draws(key):
    k_slot, *k_batch = jax.random.split(key, S + 1)
    slot = np.array(jax.random.permutation(k_slot, S))
    perms = np.stack([np.array(jax.random.permutation(k, B)) for k in k_batch])
    return torch.from_numpy(slot), torch.from_numpy(perms)


def _jax_trainer():
    return jtrainer.Trainer(jmodels.SuDORMRFImproved(**TOY, block_impl="fma"),
                            jtrainer.TrainerConfig(**CFG),
                            mesh=make_mesh(devices=jax.devices()[:1]))


def _jax_init():
    model = jmodels.SuDORMRFImproved(**TOY, block_impl="fma")
    return model.init(jax.random.key(0), jnp.zeros((1, 1, T)))["params"]


def _port_state():
    model = models.get_model("relu", **TOY, block_impl="fma",
                             generator=torch.Generator().manual_seed(5))
    tr = ttrainer.Trainer(model, ttrainer.TrainerConfig(**CFG))
    return tr, tr.init_state()


def _assert_params_close(model, jparams, rtol, atol):
    want = params_to_state_dict(jax.tree.map(np.asarray, jparams), model.state_dict().keys())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def test_jax_train_state_resumes_in_the_port(tmp_path):
    """Two steps of JAX's Trainer, saved by JAX's CheckpointManager and
    restored by the port's; then one more step in each agrees."""
    jt = _jax_trainer()
    jstate = jt.state_from_params(_jax_init())
    for i in range(2):
        jstate, _ = jt.train_step(jstate, jnp.asarray(_sources(20 + i)), jax.random.key(i))
    jcheckpoint.CheckpointManager(str(tmp_path), "relu").save(jstate, "relu_epoch_1")

    tr, state = _port_state()
    state = CheckpointManager(str(tmp_path), "relu").restore(state, "relu_epoch_1")
    assert state.step == 2
    assert {float(s["step"]) for s in state.optimizer.state.values()} == {2.0}
    _assert_params_close(state.model, jstate.params, 0, 0)

    batch, key = _sources(22), jax.random.key(7)
    jstate, jm = jt.train_step(jstate, jnp.asarray(batch), key)
    state, m = tr.train_step(state, batch, _jax_draws(key))
    assert abs(float(jm["loss"])) < CLAMP
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_params_close(state.model, jstate.params, 1e-5, 1e-5)


def test_port_train_state_is_read_by_jax(tmp_path):
    """A port TrainState after one step, saved by the port's
    CheckpointManager, restored by JAX's into its template: the same step,
    Adam count and moments, and JAX's forward with those params gives the
    port's output."""
    tr, state = _port_state()
    key = jax.random.key(3)
    state, _ = tr.train_step(state, _sources(30), _jax_draws(key))
    CheckpointManager(str(tmp_path), "relu").save(state, "relu_epoch_1")

    jt = _jax_trainer()
    template = jt.state_from_params(_jax_init())
    # the layout: every path, shape and dtype of JAX's own state dict
    flat = lambda tree: {jax.tree_util.keystr(k): (np.shape(v), np.asarray(v).dtype)
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    written = read_checkpoint(str(tmp_path / "relu_epoch_1"))
    assert flat(written) == flat(flax.serialization.to_state_dict(template))
    assert written["opt_state"]["0"] == {}  # clip_by_global_norm's EmptyState
    got = jcheckpoint.CheckpointManager(str(tmp_path), "relu").restore(template, "relu_epoch_1")
    assert int(got.step) == 1
    adam, sched = got.opt_state[1]
    assert int(adam.count) == 1 and int(sched.count) == 1
    keys = state.model.state_dict().keys()
    mu = params_to_state_dict(jax.tree.map(np.asarray, adam.mu), keys)
    for name, p in state.model.named_parameters():
        assert torch.equal(state.optimizer.state[p]["exp_avg"], mu[name]), name

    x = _sources(31)[:, :1]
    want = jmodels.SuDORMRFImproved(**TOY, block_impl="fma").apply(
        {"params": got.params}, jnp.asarray(x))
    with torch.no_grad():
        out = state.model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_run_experiment_resumes_a_jax_checkpoint(tmp_path, capsys):
    """A JAX TrainState after 3 steps, saved as epoch 1 in the port's
    checkpoint directory: ``run_experiment(resume=True)`` continues at its
    step and Adam step, and saves the next epoch in the same layout."""
    from sudo_rm_rf_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
    from sudo_rm_rf_tpu_torch.data.hierarchical import AugmentedOnlineMixingDataset
    from sudo_rm_rf_tpu_torch.data.synthetic import write_hierarchical_corpus
    from sudo_rm_rf_tpu_torch.train.experiment import run_experiment
    from sudo_rm_rf_tpu_torch.utils import ExperimentLogger

    jt = _jax_trainer()
    jstate = jt.state_from_params(_jax_init())
    for i in range(3):
        jstate, _ = jt.train_step(jstate, jnp.asarray(_sources(40 + i)), jax.random.key(i))
    ckpt_dir = tmp_path / "ckpt" / "aug"
    jcheckpoint.CheckpointManager(str(ckpt_dir), "relu").save(jstate, "relu_epoch_1")

    root = write_hierarchical_corpus(str(tmp_path / "corpus"), 3, 2, 0, 2, 2, seconds=0.5)
    ds = {split: AugmentedOnlineMixingDataset(
        input_dataset_p=[os.path.join(root, split)], n_samples=4, sample_rate=8000,
        selected_timelength=0.1, fixed_seed=0 if split == "train" else 42)
        for split in ("train", "val")}
    gens = {split: d.get_generator(batch_size=2, shuffle=split == "train", num_workers=1)
            for split, d in ds.items()}
    config = ExperimentConfig(
        model=ModelConfig(**TOY, block_impl="fma"),
        data=DataConfig(train=("AUGMENTED_WSJMIX",), val=("AUGMENTED_WSJMIX",)),
        train=TrainConfig(n_epochs=2, save_checkpoint_every=1, loss_clamp=CLAMP,
                          checkpoints_path=str(tmp_path / "ckpt")),
        experiment_name="aug")
    logger = ExperimentLogger(str(tmp_path / "logs"), "aug")
    state, history = run_experiment(config, generators=gens, logger=logger, resume=True,
                                    device="cpu")
    assert "resumed from epoch 1: step 3, Adam step 3" in capsys.readouterr().out
    assert state.step == 5 and len(history) == 1
    saved = jcheckpoint.CheckpointManager(str(ckpt_dir), "relu").restore(
        jstate, "relu_epoch_2")
    assert int(saved.step) == 5 and int(saved.opt_state[1][0].count) == 5


def test_torch_save_checkpoints_are_still_restored(tmp_path):
    """A file of earlier versions of the port: torch.save of the step, the
    model's state_dict and the optimizer's."""
    tr, state = _port_state()
    state, _ = tr.train_step(state, _sources(50), _jax_draws(jax.random.key(0)))
    path = tmp_path / "relu_epoch_1"
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}, path)
    _, fresh = _port_state()
    load_jax_params(fresh.model, jax.tree.map(np.asarray, _jax_init()))
    fresh = CheckpointManager(str(tmp_path), "relu").restore(fresh, "relu_epoch_1")
    assert fresh.step == 1
    for a, b in zip(fresh.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    sa, sb = fresh.optimizer.state_dict()["state"], state.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"]) for i in sb)
    (tmp_path / "junk").write_bytes(b"\x00\x01")
    with pytest.raises(ValueError, match="neither a msgpack nor a torch.save"):
        CheckpointManager(str(tmp_path), "relu").restore(fresh, "junk")


@pytest.mark.parametrize("fmt", ["zip", "legacy", "msgpack"])
def test_checkpoints_are_told_apart_by_their_bytes(tmp_path, fmt):
    """The serving loader (``models.load_checkpoint_model``) and
    ``CheckpointManager.restore`` share one rule, the file's first bytes: a
    suffix-less ``torch.save`` file (zip or the older pickle) and a msgpack
    file named ``.pt`` each load in both."""
    tr, state = _port_state()
    state, _ = tr.train_step(state, _sources(50), _jax_draws(jax.random.key(0)))
    weights, train_state = tmp_path / "weights", tmp_path / "relu_epoch_1"
    if fmt == "msgpack":
        weights, train_state = tmp_path / "weights.pt", tmp_path / "relu_epoch_1.pt"
        save_train_state(state, str(weights))
        save_train_state(state, str(train_state))
    else:
        zipped = fmt == "zip"
        torch.save(state.model.state_dict(), weights, _use_new_zipfile_serialization=zipped)
        torch.save({"step": state.step, "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()}, train_state,
                   _use_new_zipfile_serialization=zipped)
    want = "msgpack" if fmt == "msgpack" else "torch"
    assert checkpoint_format(str(weights)) == checkpoint_format(str(train_state)) == want
    model = models.load_checkpoint_model("relu", dict(TOY, block_impl="fma"), str(weights),
                                         "cpu")
    for a, b in zip(model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    _, fresh = _port_state()
    fresh = CheckpointManager(str(tmp_path), "relu").restore(fresh, path=str(train_state))
    assert fresh.step == 1
    for a, b in zip(fresh.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    sa, sb = fresh.optimizer.state_dict()["state"], state.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sb)
