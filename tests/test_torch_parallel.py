"""The port's data and tensor parallelism (``parallel/``, the trainer over a
mesh, compute TP in the blocks, DP overlap-add, the CLIs under a launch)
against the JAX package's multi-device mesh, on the CPU.

One gloo group of 4 CPU ranks is spawned once for the module
(``tests/_torch_parallel_worker.py``) and runs every case on sub-meshes
(4, 1), (2, 1), (2, 2) and (1, 4). Meanwhile this process computes the
oracles: the one-process port step, and JAX on the 8-device virtual CPU
mesh of ``tests/conftest.py`` at the same global batch. Both packages start
from the port's seeded init (handed to JAX as its param tree through
``convert.params_to_flax``) at the TINY widths of
``tests/test_distributed.py:61-64``. The JAX oracles are its own tests' runs:
``test_trainer.py:111-135`` (DP), ``:179-205`` (storage TP), ``:207-228``
(``state_from_params``), ``:230-265`` (compute TP), ``test_distributed.py:
61-80`` (process-local feeding), ``test_pallas_uconv.py:94-123``
(``improved_forward_fast(tp_mesh=...)``) and ``test_utils_inference.py:
160-182`` (DP overlap-add).

Tolerances are JAX's own: the loss abs 1e-4, params rtol 1e-4 with atol
1e-5 (``test_trainer.py:132-135``), the TP serving forward rtol 1e-4 with
atol 1e-5 (``test_pallas_uconv.py:112``), overlap-add rtol 1e-5 with atol
1e-6 (``test_utils_inference.py:179-181``); the port against JAX at the
same bounds as ``tests/test_model_parity.py``'s 1e-4; params across ranks
bit-identical; the CLI's int16 within 1 LSB.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.inference.overlap_add import OverlapAddSeparator as JaxOLA
from sudo_rm_rf_tpu.models.fast_inference import improved_forward_fast as jax_fast
from sudo_rm_rf_tpu.parallel import make_mesh as jax_mesh
from sudo_rm_rf_tpu.parallel import tp_param_shardings as jax_tp_shardings
from sudo_rm_rf_tpu.train import Trainer as JaxTrainer
from sudo_rm_rf_tpu.train import TrainerConfig as JaxConfig
from sudo_rm_rf_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from sudo_rm_rf_tpu_torch import models, parallel
from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
from sudo_rm_rf_tpu_torch.convert import load_jax_params, params_to_flax
from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import torch_key_to_flax_path
from sudo_rm_rf_tpu_torch.data.synthetic import write_wham_corpus, write_whamr_corpus
from sudo_rm_rf_tpu_torch.inference import OverlapAddSeparator
from sudo_rm_rf_tpu_torch.inference.sequence_parallel import default_halo_frames
from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast
from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig
from sudo_rm_rf_tpu_torch.utils import CheckpointManager

TINY = dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=2,
            enc_kernel_size=9, enc_num_basis=16, num_sources=2)
FAST_HP = dict(out_channels=32, in_channels=64, enc_num_basis=24, num_blocks=2,
               upsampling_depth=3, enc_kernel_size=21, num_sources=2)
OLA_HP = dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=3,
              enc_kernel_size=17, enc_num_basis=16, num_sources=2)
SEQ_HP = dict(TINY, num_blocks=2, upsampling_depth=3, enc_kernel_size=17)
LOSS_ABS = 1e-4
PARAMS = dict(rtol=1e-4, atol=1e-5)
FAST = dict(rtol=1e-4, atol=1e-5)
OLA = dict(rtol=1e-5, atol=1e-6)
FS = 8000
WORLD = 4


def _sources(b, t, seed):
    return np.random.default_rng(seed).standard_normal((b, 2, t)).astype(np.float32)


def _prepare(draws, batch):
    return batch.sum(dim=1, keepdim=True), batch


def _jprepare(key, batch):
    return batch.sum(1, keepdims=True), batch


def _port_model(hp, seed, **kw):
    return models.get_model("relu", **hp, **kw, generator=torch.Generator().manual_seed(seed))


def _one_process(sd, steps, cfg, src, hp=TINY, **kw):
    """The port's one-process run: (loss, grad norm, params, per-step params)."""
    model = models.get_model("relu", **hp, **kw)
    model.load_state_dict(sd)
    trainer = Trainer(model, TrainerConfig(**cfg), prepare_batch=_prepare)
    state = trainer.init_state()
    for _ in range(steps):
        state, m = trainer.train_step(state, torch.from_numpy(src), None)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params={k: v.clone() for k, v in model.state_dict().items()})


def _jax_run(params, steps, cfg, src, mesh, keys=None, **model_kw):
    """JAX's trainer from the port's params: (loss, params as a port state_dict)."""
    trainer = JaxTrainer(jmodels.SuDORMRFImproved(**TINY, **model_kw), JaxConfig(**cfg),
                         prepare_batch=_jprepare, mesh=mesh)
    state = trainer.state_from_params(jax.tree.map(jnp.asarray, params))
    for i in range(steps):
        key = jax.random.key(i if keys is None else keys[i])
        state, metrics = trainer.train_step(state, jnp.asarray(src), key)
    return dict(loss=float(metrics["loss"]), state=state, trainer=trainer)


def _as_port(jax_params, hp=TINY):
    model = models.get_model("relu", **hp)
    load_jax_params(model, jax.tree.map(np.asarray, jax.device_get(jax_params)))
    return model.state_dict()


def _rank_loss(sd, src):
    """The one-process port's loss of a batch at the case's params."""
    model = models.get_model("relu", **TINY)
    model.load_state_dict(sd)
    trainer = Trainer(model, TrainerConfig(loss_clamp=0.0), prepare_batch=_prepare)
    with torch.no_grad():
        mixture, targets = _prepare(None, torch.from_numpy(src))
        return float(trainer.loss_fn(trainer.forward(model, mixture), targets))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the 4-rank group, compute the oracles meanwhile, and return
    (case, each rank's results, the one-process port runs, JAX's runs)."""
    import _torch_parallel_worker
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("parallel")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    sd = _port_model(TINY, 0).state_dict()
    ctp_sd = _port_model(dict(TINY, block_impl="fma"), 0).state_dict()
    fast = _port_model(FAST_HP, 1)
    ola = _port_model(OLA_HP, 2)
    clamp_src = _sources(4, 1024, 9)
    l0, l1 = _rank_loss(sd, clamp_src[:2]), _rank_loss(sd, clamp_src[2:])
    g = _rank_loss(sd, clamp_src)
    lo, hi = sorted((abs(l0), abs(l1)))
    # inside: the global mean lies inside the clamp, one rank's mean outside;
    # saturated: the reverse
    seq = _port_model(SEQ_HP, 3)
    torch.save(seq.state_dict(), tmp / "seq.pt")
    align = SEQ_HP["enc_kernel_size"] // 2 * 2 ** SEQ_HP["upsampling_depth"]
    halo = default_halo_frames(SEQ_HP["num_blocks"], SEQ_HP["upsampling_depth"])
    per = -(-halo * (SEQ_HP["enc_kernel_size"] // 2) // align) * align
    n = per * WORLD  # pads alike for 1 and 4 shards
    mix = (0.2 * np.sin(2 * np.pi * 440 / FS * np.arange(n))
           + 0.05 * np.random.default_rng(8).standard_normal(n)).astype(np.float32)
    wavfile.write(tmp / "mix.wav", FS, (mix * 32767).astype(np.int16))
    hp_argv = [a for k, v in SEQ_HP.items() if k != "num_sources" for a in (f"--{k}", str(v))]
    sep_argv = ["--checkpoint", str(tmp / "seq.pt"), "--model_type", "relu", "--input",
                str(tmp / "mix.wav"), "--mode", "seq_parallel", "--device", "cpu", *hp_argv]
    root = write_wham_corpus(str(tmp / "wham"), n_train=4, n_val=2, seconds=1.0, fs=FS,
                             seed=1)
    whamr = write_whamr_corpus(str(tmp / "whamr"), n_train=0, n_val=0, n_test=2,
                               seconds=(0.75, 1.0), fs=FS, seed=6)
    eval_argv = ["--checkpoint", str(tmp / "seq.pt"), "--model_type", "relu",
                 "--root_dirpath", whamr, "--dataset", "WHAMR", "--separation_task",
                 "noisy_reverberant", "-fs", str(FS), "--full_length", "--full_length_mode",
                 "seq_parallel", "--bss_filter_taps", "1", "--device", "cpu",
                 "--out_pickle", str(tmp / "eval4.pkl"), *hp_argv]
    tiny_argv = [a for k, v in TINY.items() if k != "num_sources" for a in (f"--{k}", str(v))]
    train_argv = ["--train", "WHAM", "--val", "WHAM", "--wham_root", root, "--n_epochs", "1",
                  "-bs", "2", "--audio_timelength", "0.5", "--n_jobs", "1", "--n_model", "2",
                  "--block_impl", "fma", "--loss_clamp", "0", "-elp", str(tmp / "logs"),
                  "-clp", str(tmp / "ckpt_cli"), "--device", "cpu", *tiny_argv]
    case = dict(
        hp=TINY, sd=sd, dp_src=torch.from_numpy(_sources(8, 1024, 4)),
        dist_src=torch.from_numpy(np.random.default_rng(42).standard_normal(
            (4, 2, 1024)).astype(np.float32)),
        dist_sd=sd, clamp_src=torch.from_numpy(clamp_src),
        clamp_inside=(abs(g) + hi) / 2, clamp_saturated=(lo + abs(g)) / 2,
        tp_src=torch.from_numpy(_sources(8, 1024, 7)),
        chain_src=torch.from_numpy(np.stack([_sources(4, 1024, 21), _sources(4, 1024, 22)])),
        pool_src=torch.from_numpy(_sources(8, 1024, 23)),
        ctp_hp=dict(block_impl="fma", tp=True), ctp_sd=ctp_sd,
        ctp_src=torch.from_numpy(_sources(8, 1024, 17)),
        fast_hp=FAST_HP, fast_sd=fast.state_dict(),
        fast_x=torch.from_numpy(np.random.default_rng(5).standard_normal(
            (4, 1, 661)).astype(np.float32)),
        ola_hp=OLA_HP, ola_sd=ola.state_dict(),
        ola_mix=np.random.default_rng(3).standard_normal(11 * 400 + 57).astype(np.float32),
        separate_argv=sep_argv + ["--out_dir", str(tmp / "sep4")], train_argv=train_argv,
        evaluate_argv=eval_argv)
    torch.save(case, tmp / "case.pt")
    ctx = mp.start_processes(_torch_parallel_worker.run, nprocs=WORLD, start_method="spawn",
                             join=False, args=(WORLD, str(tmp / "store"), str(tmp / "case.pt"),
                                               str(tmp)))
    try:
        params, ctp_params = params_to_flax(_port_model(TINY, 0)), params_to_flax(
            _port_model(dict(TINY, block_impl="fma"), 0))
        two_dev = jax_mesh(devices=jax.devices()[:2])
        src = {k: case[k].numpy() for k in ("dp_src", "dist_src", "tp_src", "ctp_src")}
        one = {
            "dp4": _one_process(sd, 3, {}, src["dp_src"]),
            "dp2_local": _one_process(sd, 1, {}, src["dist_src"]),
            "clamp_inside": _one_process(sd, 1, dict(loss_clamp=case["clamp_inside"]),
                                         clamp_src),
            "clamp_saturated": _one_process(sd, 1, dict(loss_clamp=case["clamp_saturated"]),
                                            clamp_src),
            "accum2": _one_process(sd, 2, dict(grad_accum_steps=2), src["dp_src"]),
            "tp_storage": _one_process(sd, 2, {}, src["tp_src"]),
            "tp_compute": _one_process(ctp_sd, 2, {}, src["ctp_src"], block_impl="fma"),
            **{f"dp2_{how}": _torch_parallel_worker.fed_steps(case, None, how)
               for how in ("chain", "resident")},
        }
        tp_mesh = jax_mesh(n_model=4)
        jx = {
            "dp4": _jax_run(params, 3, {}, src["dp_src"], jax_mesh()),
            "dp2_local": _jax_run(params, 1, dict(learning_rate=1e-3), src["dist_src"],
                                  two_dev, keys=[7]),
            "clamp_inside": _jax_run(params, 1, dict(loss_clamp=case["clamp_inside"]),
                                     clamp_src, two_dev),
            "clamp_saturated": _jax_run(params, 1, dict(loss_clamp=case["clamp_saturated"]),
                                        clamp_src, two_dev),
            "accum2": _jax_run(params, 2, dict(grad_accum_steps=2), src["dp_src"], jax_mesh()),
            "tp_storage": _jax_run(params, 2, dict(shard_params=True), src["tp_src"],
                                   jax_mesh(n_model=2)),
            "tp_compute": _jax_run(ctp_params, 2, dict(shard_params=True), src["ctp_src"],
                                   tp_mesh, block_impl="fma", tp_mesh=tp_mesh),
        }
        fhp = {k: FAST_HP[k] for k in ("num_blocks", "upsampling_depth", "enc_kernel_size",
                                       "num_sources")}
        jx["fast_tp"] = np.asarray(jax.jit(lambda p, v: jax_fast(
            p, v, impl="fma", tp_mesh=tp_mesh, **fhp))(
                jax.tree.map(jnp.asarray, params_to_flax(fast)), jnp.asarray(case["fast_x"])))
        jola = jmodels.get_model("relu", **OLA_HP)
        jx["ola"] = JaxOLA(jola, jax.tree.map(jnp.asarray, params_to_flax(ola)),
                           chunk_samples=800, num_sources=2, batch_chunks=5,
                           mesh=jax_mesh()).separate(case["ola_mix"])
        one["ola"] = OverlapAddSeparator(ola, chunk_samples=800, num_sources=2,
                                         batch_chunks=8).separate(case["ola_mix"])
        one["fast_tp"] = improved_forward_fast(fast, case["fast_x"], impl="fma")
        assert separate_main(sep_argv + ["--out_dir", str(tmp / "sep1")]) == 0
    finally:
        while not ctx.join(timeout=300):
            pass
        torch.set_num_threads(threads)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(case=case, ranks=ranks, one=one, jax=jx, tmp=tmp, losses=(l0, l1, g),
                whamr=whamr, seq=seq)


TRAIN_CASES = {  # case -> the ranks of its mesh
    "dp4": range(4), "dp2_local": range(2), "clamp_inside": range(2),
    "clamp_saturated": range(2), "accum2": range(4), "tp_storage": range(4),
    "tp_compute": range(4),
}


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_step_matches_one_process_and_jax(run, name):
    """Each case's loss and params against the one-process port and JAX's
    mesh; the whole params bit-identical on every rank after every step."""
    ranks = [run["ranks"][r][name] for r in TRAIN_CASES[name]]
    one, jx = run["one"][name], run["jax"][name]
    jax_params = _as_port(jx["state"].params)
    for got in ranks:
        assert got["loss"] == pytest.approx(one["loss"], abs=LOSS_ABS)
        assert got["loss"] == pytest.approx(jx["loss"], abs=LOSS_ABS)
        for k, want in one["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), want.numpy(), **PARAMS,
                                       err_msg=k)
            np.testing.assert_allclose(got["params"][k].numpy(), jax_params[k].numpy(),
                                       **PARAMS, err_msg=k)
    for step in range(len(ranks[0]["per_step"])):
        for got in ranks[1:]:
            for k, v in ranks[0]["per_step"][step].items():
                assert torch.equal(got["per_step"][step][k], v), (step, k)
    assert all(r[name] is None for i, r in enumerate(run["ranks"]) if i not in TRAIN_CASES[name])


@pytest.mark.parametrize("how", ["chain", "resident"])
def test_dp_chain_and_resident_epoch_match_one_process(run, how):
    """Two chained steps and a two-step resident epoch over DP 2: each
    step's loss against the one-process run's (JAX's loss bound), the params
    within JAX's bounds, bit-identical on both ranks; on each rank the chain
    is its two single steps bit for bit."""
    one = run["one"][f"dp2_{how}"]
    ranks = [run["ranks"][r][f"dp2_{how}"] for r in range(2)]
    assert len(one["losses"]) == 2
    for got in ranks:
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=0, atol=LOSS_ABS)
        for k, want in one["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), want.numpy(), **PARAMS,
                                       err_msg=k)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert all(torch.equal(ranks[1]["params"][k], v) for k, v in ranks[0]["params"].items())
    assert all(r[f"dp2_{how}"] is None for r in run["ranks"][2:])
    if how == "chain":
        for r in range(2):
            steps = run["ranks"][r]["dp2_steps"]
            assert ranks[r]["losses"] == steps["losses"]
            assert all(torch.equal(steps["params"][k], v) for k, v in ranks[r]["params"].items())


def test_clamp_cases_straddle_the_clamp(run):
    """The ranks' local mean losses lie on both sides of each case's clamp,
    and the global mean on the side that decides: inside, the ranks train
    as the global batch does; saturated, no param moves."""
    l0, l1, g = (abs(v) for v in run["losses"])
    case = run["case"]
    c = case["clamp_inside"]
    assert min(l0, l1) < c < max(l0, l1) and g < c
    c = case["clamp_saturated"]
    assert min(l0, l1) < c < max(l0, l1) and g > c
    sd = run["case"]["sd"]
    for got in (run["ranks"][r]["clamp_saturated"] for r in range(2)):
        assert got["grad_norm"] == 0.0 and got["loss"] == pytest.approx(c, abs=1e-6)
        for k, v in sd.items():
            assert torch.equal(got["params"][k], v), k
    inside = run["ranks"][0]["clamp_inside"]
    assert inside["grad_norm"] > 0 and not torch.equal(inside["params"]["encoder.weight"],
                                                       sd["encoder.weight"])


def test_storage_tp_shards_what_jax_shards(run):
    """(2, 2) storage TP: each rank holds its model index's rows of every
    param JAX's ``tp_param_shardings`` shards, whole every other one."""
    jrule = jax_tp_shardings(
        jax.tree.map(jnp.asarray, params_to_flax(_port_model(TINY, 0))), jax_mesh(n_model=2))
    flat = {"/".join(k.key for k in path): s for path, s in
            jax.tree_util.tree_flatten_with_path(jrule)[0]}
    want = sorted(n for n in run["case"]["sd"]
                  if tuple(flat["/".join(torch_key_to_flax_path(n))].spec)[:1] == ("model",))
    for r in range(WORLD):
        got = run["ranks"][r]["tp_storage"]
        assert got["sharded"] == want
        for k, v in run["case"]["sd"].items():
            rows = v.shape[0] // 2 if k in want else v.shape[0]
            assert got["own"][k].shape == (rows, *v.shape[1:]), k
            if k in want:  # rank r sits at (r // 2, r % 2): model index r % 2
                part = got["params"][k][(r % 2) * rows : (r % 2 + 1) * rows]
                assert torch.equal(got["own"][k], part), k
    shard_params = run["ranks"][0]["tp_compute"]["sharded"]
    assert shard_params and set(shard_params) <= set(want)


def test_state_from_params_places_like_init_state(run):
    for r in range(WORLD):
        got = run["ranks"][r]["state_from_params"]
        assert got["same"] and np.isfinite(got["loss"])
        assert got["shapes"]["bottleneck.weight"] == (8, 16, 1)
        assert got["shapes"]["encoder.weight"] == (16, 1, 9)


@pytest.mark.parametrize("shape", ["(2, 2)", "(1, 4)"])
def test_fast_forward_tp_matches_jax(run, shape):
    want_jax, want_one = run["jax"]["fast_tp"], run["one"]["fast_tp"].numpy()
    for r in range(WORLD):
        got = run["ranks"][r]["fast_tp"][shape].numpy()
        np.testing.assert_allclose(got, want_one, **FAST)
        np.testing.assert_allclose(got, want_jax, **FAST)


def test_overlap_add_dp_matches_the_unsharded_separator(run):
    for r in range(WORLD):
        got = run["ranks"][r]["ola"]
        assert got["batch_chunks"] == 8
        np.testing.assert_allclose(got["est"], run["one"]["ola"], **OLA)
        np.testing.assert_allclose(got["est"], run["jax"]["ola"], **OLA)


def test_checkpoint_of_the_ranks_loads_in_one_process_and_jax(run):
    """The (2, 2) storage-TP run's checkpoint, written by rank 0 with its
    shards gathered, restores into a one-process port run and into JAX's
    ``CheckpointManager``."""
    path = run["tmp"] / "ckpt" / "relu_epoch_2"
    assert sorted(os.listdir(run["tmp"] / "ckpt")) == ["relu_epoch_2"]
    want = run["ranks"][0]["tp_storage"]["params"]
    model = models.get_model("relu", **TINY)
    trainer = Trainer(model, TrainerConfig(), prepare_batch=_prepare)
    state = CheckpointManager(str(run["tmp"] / "ckpt"), "relu").restore(
        trainer.init_state(), path=str(path))
    assert state.step == 2
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k
    steps = {int(s["step"]) for s in state.optimizer.state.values()}
    assert steps == {2}
    jt = run["jax"]["tp_storage"]["trainer"]
    target = jt.state_from_params(jax.tree.map(jnp.asarray, params_to_flax(model)))
    restored = JaxCheckpointManager(str(run["tmp"] / "ckpt"), "relu").restore(
        target, path=str(path))
    assert int(restored.step) == 2
    for k, v in _as_port(restored.params).items():
        assert torch.equal(v, want[k]), k


def test_seq_parallel_cli_over_four_ranks_within_one_lsb_of_one_rank(run):
    """``sudo-torch-separate --mode seq_parallel`` launched over the 4 ranks
    (one time shard a rank, rank 0 writing) against the one-rank CLI."""
    for s in (1, 2):
        one = wavfile.read(run["tmp"] / "sep1" / f"mix_s{s}.wav")[1].astype(np.int32)
        four = wavfile.read(run["tmp"] / "sep4" / f"mix_s{s}.wav")[1].astype(np.int32)
        assert one.shape == four.shape and np.abs(one - four).max() <= 1


def test_evaluate_cli_seq_parallel_over_four_ranks_scores_four_shards(run):
    """``sudo-torch-evaluate --full_length --full_length_mode seq_parallel``
    over the 4 ranks: rank 0 pickles the scores of what four time shards
    separate (``LocalShards(4)`` in one process), within 1e-3 dB."""
    import pickle

    from sudo_rm_rf_tpu_torch.data.setup import create_loader_for_simple_dataset
    from sudo_rm_rf_tpu_torch.inference import sequence_parallel as sp
    from sudo_rm_rf_tpu_torch.losses import PermInvariantSISDR

    with open(run["tmp"] / "eval4.pkl", "rb") as fh:
        got = pickle.load(fh)
    sep = sp.SequenceParallelSeparator(run["seq"].eval(), comm=sp.LocalShards(WORLD))
    metric = PermInvariantSISDR(n_sources=2, zero_mean=True, backward_loss=False,
                                improvement=True, return_individual_results=True)
    data = create_loader_for_simple_dataset(
        dataset_name="WHAMR", separation_task="noisy_reverberant", data_split="test",
        sample_rate=FS, zero_pad=True, timelength=-1.0, root_dirpath=run["whamr"])
    want = []
    for i in range(2):
        item = data[i]
        mix = np.asarray(item[0]).sum(axis=0)
        est = torch.from_numpy(sep.separate(mix))[None]
        tgt = torch.from_numpy(np.asarray(item[-1])[:2])[None]
        want += metric(est, tgt, initial_mixtures=torch.from_numpy(
            np.asarray(mix, np.float32))[None, None]).tolist()
    np.testing.assert_allclose(got["si_sdri"], want, atol=1e-3)


def test_train_cli_n_model_2_trains_and_its_checkpoint_loads(run):
    """``sudo-torch-train --n_model 2`` over the 4 ranks (a (2, 2) grid,
    compute TP under fma): rank 0's best checkpoint loads into a
    one-process port model."""
    ckpt = run["tmp"] / "ckpt_cli" / "sudo_tpu_experiment"
    best = [p for p in os.listdir(ckpt) if p.startswith("best_") and not p.endswith(".json")]
    assert len(best) == 1
    model = models.load_checkpoint_model("relu", TINY, str(ckpt / best[0]), "cpu")
    with torch.no_grad():
        assert torch.isfinite(model(torch.randn(1, 1, 400))).all()


def test_compute_tp_requires_fma():
    """JAX's ValueErrors for a compute-TP mesh on another block form."""
    mesh = parallel.make_mesh()
    with pytest.raises(ValueError, match="block_impl='fma'"):
        models.get_model("relu", **TINY, tp_mesh=mesh)
    with pytest.raises(ValueError, match="impl='fma'"):
        improved_forward_fast(models.get_model("relu", **TINY), torch.zeros(1, 1, 400),
                              impl="xla", tp_mesh=mesh)


def test_mesh_layout_and_rows_as_jax():
    """rank r at (r // n_model, r % n_model), as np.reshape lays JAX's
    devices out; a batch that does not divide the data axis raises JAX's
    error."""
    grid = np.arange(8).reshape(4, 2)
    for r in range(8):
        mesh = parallel.Mesh(grid, r)
        assert mesh.coords == (r // 2, r % 2)
        assert parallel.batch_rows(mesh, 8) == slice(2 * (r // 2), 2 * (r // 2) + 2)
    with pytest.raises(ValueError, match="must be divisible by the data-parallel mesh"):
        parallel.batch_rows(parallel.Mesh(grid, 0), 6)
    one = parallel.make_mesh()
    assert one.shape == {"data": 1, "model": 1} and one.data_group is None
    assert not parallel.maybe_distributed_initialize()


def test_rank_device_refuses_more_ranks_than_cards(monkeypatch):
    env = dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", LOCAL_WORLD_SIZE="2",
               MASTER_ADDR="localhost", MASTER_PORT="1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="share_device"):
        parallel.rank_device("cuda")
    assert parallel.rank_device("cuda", share_device=True) == torch.device("cuda", 0)
    assert parallel.rank_device("cuda:0") == torch.device("cuda", 0)
    assert parallel.rank_device("cpu") == torch.device("cpu")
