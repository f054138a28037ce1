"""The port's exact long-form separation (``inference/sequence_parallel.py``)
against the JAX package, on the CPU: the Improved model, the communicators,
the separator and both CLIs' seq_parallel modes.

Sizes are JAX's (tests/test_sequence_parallel.py:25-26): out 16, in 32, 2
blocks, depth 3, encoder kernel 17, 16 bases. Both packages get the same
params, the port's seeded init handed to JAX as its param tree
(``convert.params_to_flax``; no JAX init compiles), and the same numpy
inputs. The JAX side runs
``make_seq_mesh(n)`` of the 8-device virtual CPU mesh (tests/conftest.py),
once a case (module-scoped fixtures: each shard_map compiles once); the port
runs ``LocalShards(n)``, and a 2-rank gloo group (``DistributedShards``) in
one module-scoped fixture. Tolerances are JAX's: forwards rtol 1e-3, atol
1e-4 (tests/test_sequence_parallel.py:63-64), the separator 2e-4 (:132);
the CLI's int16 within 1 LSB of the Python API.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sudo_rm_rf_tpu.inference import sequence_parallel as jsp
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.cli.evaluate import main as evaluate_main
from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
from sudo_rm_rf_tpu_torch.convert import params_to_flax
from sudo_rm_rf_tpu_torch.data.base import read_wav
from sudo_rm_rf_tpu_torch.data.synthetic import write_whamr_corpus
from sudo_rm_rf_tpu_torch.inference import sequence_parallel as sp
from sudo_rm_rf_tpu_torch.losses import PermInvariantSISDR
from sudo_rm_rf_tpu_torch.models.fast_inference import (
    groupcomm_forward_fast,
    improved_forward_fast,
)

CFG = dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3,
           enc_kernel_size=17, enc_num_basis=16, num_sources=2)
GC_CFG = dict(CFG, out_channels=32, in_channels=64, group_size=4)
TOL = dict(rtol=1e-3, atol=1e-4)
SEP_TOL = dict(rtol=2e-4, atol=2e-4)
STRIDE = CFG["enc_kernel_size"] // 2
ALIGN = STRIDE * 2 ** CFG["upsampling_depth"]
HALO = sp.default_halo_frames(CFG["num_blocks"], CFG["upsampling_depth"])
FS = 8000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these tiny tensors: in a loaded parallel run
    torch's default pool oversubscribes the cores and every small op waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _per(halo=HALO, blocks=3):
    """Samples a shard owns: a halo's worth and ``blocks`` alignments, aligned."""
    return -(-max(halo * STRIDE, blocks * ALIGN) // ALIGN) * ALIGN


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def relu():
    """(JAX params, the port model holding them)."""
    model = models.get_model("relu", **CFG, generator=torch.Generator().manual_seed(0)).eval()
    return params_to_flax(model), model


def _jax_seq(params, x, n, **kw):
    return np.asarray(jsp.improved_forward_seq(
        params, jnp.asarray(x), jsp.make_seq_mesh(n), num_blocks=CFG["num_blocks"],
        depth=CFG["upsampling_depth"], enc_kernel_size=CFG["enc_kernel_size"],
        num_sources=2, **kw))


@pytest.mark.parametrize("n", [2, 8])
def test_improved_forward_seq_matches_jax(relu, n):
    params, model = relu
    x = _rand((1, n * _per()), n)
    got = sp.improved_forward_seq(model, torch.from_numpy(x), sp.LocalShards(n))
    want = _jax_seq(params, x, n)
    assert got.shape == want.shape == (1, 2, x.shape[1])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_local_shards_equal_the_unsharded_forward(relu, n):
    """Both global boundaries and every shard seam, batch 3."""
    model = relu[1]
    x = torch.from_numpy(_rand((3, 8 * _per()), 10 + n))
    want = improved_forward_fast(model, x[:, None], impl="fma")
    got = sp.improved_forward_seq(model, x, sp.LocalShards(n))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_too_small_halo_breaks(relu):
    """A one-level halo is not exact: the default halo is load-bearing."""
    model = relu[1]
    x = torch.from_numpy(_rand((1, 8 * _per()), 5))
    want = improved_forward_fast(model, x[:, None], impl="fma")
    tiny = 2 ** (CFG["upsampling_depth"] - 1)
    got = sp.improved_forward_seq(model, x, sp.LocalShards(8), halo_frames=tiny)
    assert (got - want).abs().max() > 1e-3
    assert torch.allclose(sp.improved_forward_seq(model, x, sp.LocalShards(8)), want,
                          rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("case,match", [
    ("short", "per-shard length 64 < halo 160"),
    ("unaligned", "not a multiple of n_shards"),
    ("halo", "not a multiple of 2"),
])
def test_forward_seq_guards(relu, case, match):
    model = relu[1]
    t, kw = {"short": (2 * ALIGN, {}), "unaligned": (2 * _per() + 8, {}),
             "halo": (2 * _per(), {"halo_frames": 21})}[case]
    with pytest.raises(ValueError, match=match):
        sp.improved_forward_seq(model, torch.zeros(1, t), sp.LocalShards(2), **kw)


@pytest.fixture(scope="module")
def jax_separation(relu):
    """JAX's separator over a 2-device mesh at an unaligned length."""
    t = 5000 + 37
    mixture = _rand(t, 2)
    sep = jsp.SequenceParallelSeparator(
        relu[0], mesh=jsp.make_seq_mesh(2), num_blocks=CFG["num_blocks"],
        upsampling_depth=CFG["upsampling_depth"],
        enc_kernel_size=CFG["enc_kernel_size"], num_sources=2)
    return mixture, sep._padded_len(t), sep.separate(mixture)


def test_separator_matches_jax(relu, jax_separation):
    mixture, padded_len, want = jax_separation
    sep = sp.SequenceParallelSeparator(relu[1], sp.LocalShards(2))
    assert sep._padded_len(len(mixture)) == padded_len
    got = sep.separate(mixture)
    assert got.shape == want.shape == (2, len(mixture)) and sep.route == "fma"
    np.testing.assert_allclose(got, want, **SEP_TOL)


def test_separator_arbitrary_length_matches_padded_fast_path(relu):
    """The pad -> shard -> crop pipeline equals the fast path on the
    identically padded input, de-standardized the same way."""
    model = relu[1]
    sep = sp.SequenceParallelSeparator(model, sp.LocalShards(8))
    t = 5000 + 37
    mixture = _rand(t, 2)
    est = sep.separate(mixture)
    mean, std = mixture.mean(), mixture.std(ddof=1)
    padded = np.zeros(sep._padded_len(t), np.float32)
    padded[:t] = (mixture - mean) / (std + 1e-9)
    ref = improved_forward_fast(model, torch.from_numpy(padded)[None, None], impl="fma")
    np.testing.assert_allclose(est, ref[0, :, :t].numpy() * std + mean, **SEP_TOL)


def test_separator_mixture_consistency(relu):
    sep = sp.SequenceParallelSeparator(relu[1], sp.LocalShards(2),
                                       mixture_consistency="uniform")
    mixture = _rand(4096, 3)
    mixture -= mixture.mean()  # the mean is added back per source
    est = sep.separate(mixture)
    assert est.shape == (2, 4096)
    assert np.abs(mixture - est.sum(axis=0)).max() < 5e-3


def test_separator_short_input_guard(relu):
    """Inputs shorter than one halo per shard still separate (extra pad)."""
    sep = sp.SequenceParallelSeparator(relu[1], sp.LocalShards(8))
    est = sep.separate(_rand(777, 4))
    assert est.shape == (2, 777) and np.isfinite(est).all()
    assert sep._padded_len(777) == 8 * _per(blocks=1)


@pytest.mark.parametrize("case", ["shards", "compute_dtype", "model_type", "cpu"])
def test_kernel_impl_refusals(relu, case):
    """impl="kernel" is K1 on one rank for relu/groupcomm_v2 on a CUDA
    tensor, in fp32 or a compute dtype; anything else raises instead of
    falling back (a bf16 separator on a CPU tensor too)."""
    model = relu[1]
    kw = dict(impl="kernel")
    if case == "shards":
        kw["comm"], match = sp.LocalShards(2), "2 shards"
    elif case == "model_type":
        model, match = models.get_model("causal", **CFG), "model type 'causal'"
    else:
        if case == "compute_dtype":
            with pytest.raises(ValueError, match="not a floating dtype"):
                sp.SequenceParallelSeparator(model, compute_dtype="int32", **kw)
            kw["compute_dtype"] = "bfloat16"
        match = "a CPU tensor"
        sep = sp.SequenceParallelSeparator(model, **kw)
        with pytest.raises(ValueError, match=match):
            sep.separate(_rand(2000, 6))
        assert sep.route is None
        return
    with pytest.raises(ValueError, match=match):
        sp.SequenceParallelSeparator(model, **kw)


def test_separator_compute_dtype_casts_a_copy_once(relu):
    """A bf16 separator runs the shard body in bf16 from a copy cast once
    for its route; the caller's model stays fp32."""
    model = relu[1]
    sep = sp.SequenceParallelSeparator(model, sp.LocalShards(2), input_normalize=False,
                                       compute_dtype="bfloat16")
    t = 3000 + 5
    x = _rand(t, 9)
    got = sep.separate(x)
    cast = sep._cast["fma"]
    assert sep.route == "fma" and cast.encoder.weight.dtype == torch.bfloat16
    assert model.encoder.weight.dtype == torch.float32
    sep.separate(x)
    assert sep._cast["fma"] is cast
    padded = torch.zeros(1, sep._padded_len(t))
    padded[0, :t] = torch.from_numpy(x)
    want = sp.improved_forward_seq(model, padded, sp.LocalShards(2), compute_dtype="bfloat16")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want[0, :, :t].numpy(), **TOL)


def test_default_route_on_the_cpu_is_the_shard_body(relu):
    sep = sp.SequenceParallelSeparator(relu[1])
    assert sep.comm.world == 1 and sep.impl is None
    sep.separate(_rand(1000, 7))
    assert sep.route == "fma"


def test_local_shards_primitives():
    comm = sp.LocalShards(3)
    v = torch.arange(3 * 2 * 4 * 5, dtype=torch.float32).reshape(3 * 2, 4, 5)
    sums = comm.all_reduce_sum(v)
    assert torch.equal(sums[:2], v.reshape(3, 2, 4, 5).sum(0))
    assert torch.equal(sums[2:4], sums[:2]) and torch.equal(sums[4:], sums[:2])
    gathered = comm.all_gather(v)
    assert torch.equal(gathered, torch.cat([v[0:2], v[2:4], v[4:6]], dim=-1))
    x = v[:, 0]  # (6, 5)
    h = comm.halo_exchange(x, 2)
    assert h.shape == (6, 9)
    assert torch.equal(h[:2, :2], torch.zeros(2, 2)) and torch.equal(h[4:, -2:], torch.zeros(2, 2))
    assert torch.equal(h[2:4, :2], x[:2, -2:]) and torch.equal(h[2:4, -2:], x[4:, :2])
    assert torch.equal(comm.rank(), torch.arange(3))


@pytest.fixture(scope="module")
def gloo_run(relu, tmp_path_factory):
    """One 2-rank gloo group (spawned once for the module) running the
    primitives and the Improved and GroupComm forwards through
    ``DistributedShards``; returns (the case, each rank's results)."""
    import _torch_seq_worker
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("gloo")
    gc = models.get_model("groupcomm_v2", **GC_CFG,
                          generator=torch.Generator().manual_seed(1)).eval()
    case = dict(prim=torch.from_numpy(_rand((2, 2, 3, 8), 20)),
                x=torch.from_numpy(_rand((2, 2 * _per()), 21)),
                relu_hp=CFG, relu_sd=relu[1].state_dict(),
                groupcomm_v2_hp=GC_CFG, groupcomm_v2_sd=gc.state_dict())
    torch.save(case, tmp / "case.pt")
    mp.start_processes(_torch_seq_worker.run, nprocs=2, start_method="spawn", join=True,
                       args=(2, str(tmp / "store"), str(tmp / "case.pt"), str(tmp)))
    return case, [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(2)], gc


def test_distributed_primitives_equal_local_shards(gloo_run):
    case, ranks, _ = gloo_run
    local = sp.LocalShards(2)
    prim = case["prim"]  # (2 shards, 2, 3, 8)
    sums = local.all_reduce_sum(prim.reshape(4, 3, 8))
    halo = local.halo_exchange(prim[:, :, 0].reshape(4, 8), 3)
    for r, got in enumerate(ranks):
        assert got["rank"].tolist() == [r]
        assert torch.equal(got["all_reduce_sum"], sums[2 * r : 2 * r + 2])
        assert torch.equal(got["halo_exchange"], halo[2 * r : 2 * r + 2])
        assert torch.equal(got["all_gather"], local.all_gather(prim.reshape(4, 3, 8)))


@pytest.mark.parametrize("name", ["relu", "groupcomm_v2"])
def test_distributed_forward_equals_local_shards(relu, gloo_run, name):
    case, ranks, gc = gloo_run
    model, forward = ((relu[1], sp.improved_forward_seq) if name == "relu"
                      else (gc, sp.groupcomm_forward_seq))
    want = forward(model, case["x"], sp.LocalShards(2))
    for got in ranks:
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    fast = (improved_forward_fast(model, case["x"][:, None], impl="fma") if name == "relu"
            else groupcomm_forward_fast(model, case["x"][:, None], impl="fma_merged"))
    np.testing.assert_allclose(ranks[0][name].numpy(), fast.numpy(), **TOL)


def _hp_argv(hp):
    return [a for k, v in hp.items() if k != "num_sources" for a in (f"--{k}", str(v))]


def test_separate_cli_seq_parallel_within_one_lsb_of_the_api(relu, tmp_path):
    """``sudo-torch-separate --mode seq_parallel`` on the CPU: JAX's
    ``_s{n}.wav`` names, peak-normalized int16 writes of the separator."""
    model = relu[1]
    ckpt = str(tmp_path / "relu.pt")
    torch.save(model.state_dict(), ckpt)
    n = 6000
    mix = (0.2 * np.sin(2 * np.pi * 440 / FS * np.arange(n))
           + 0.05 * _rand(n, 8)).astype(np.float32)
    wav = str(tmp_path / "mix.wav")
    wavfile.write(wav, FS, (mix * 32767).astype(np.int16))
    out = tmp_path / "out"
    assert separate_main(["--checkpoint", ckpt, "--model_type", "relu", "--input", wav,
                          "--out_dir", str(out), "--mode", "seq_parallel", "--device", "cpu",
                          *_hp_argv(CFG)]) == 0
    want = sp.SequenceParallelSeparator(model).separate(read_wav(wav)[1])
    for s in (1, 2):
        sr, got = wavfile.read(out / f"mix_s{s}.wav")
        ref = want[s - 1] / max(1.0, np.abs(want[s - 1]).max())
        assert sr == FS and got.shape == (n,) and got.dtype == np.int16
        assert np.abs(got.astype(np.int32) - (ref * 32767).astype(np.int32)).max() <= 1


@pytest.fixture(scope="module")
def whamr_root(tmp_path_factory):
    return write_whamr_corpus(str(tmp_path_factory.mktemp("whamr")), n_train=0, n_val=0,
                              n_test=2, seconds=(0.75, 1.0), fs=FS, seed=6)


@pytest.mark.parametrize("model_type", ["relu", "causal"])
def test_evaluate_cli_seq_parallel_scores_the_separator(tmp_path, capsys, whamr_root,
                                                        model_type):
    """``sudo-torch-evaluate --full_length --full_length_mode seq_parallel``
    scores what ``SequenceParallelSeparator`` separates."""
    import json

    from sudo_rm_rf_tpu_torch.data.setup import create_loader_for_simple_dataset

    model = models.get_model(model_type, **CFG, generator=torch.Generator().manual_seed(2))
    ckpt = str(tmp_path / "m.pt")
    torch.save(model.state_dict(), ckpt)
    argv = ["--checkpoint", ckpt, "--model_type", model_type, "--root_dirpath", whamr_root,
            "--dataset", "WHAMR", "--separation_task", "noisy_reverberant", "-fs", str(FS),
            "--full_length", "--full_length_mode", "seq_parallel", "--bss_filter_taps", "1",
            "--device", "cpu", *_hp_argv(CFG)]
    assert evaluate_main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_examples"] == 2
    assert all(np.isfinite(v) for v in summary.values() if isinstance(v, float))
    sep = sp.SequenceParallelSeparator(model.eval())
    metric = PermInvariantSISDR(n_sources=2, zero_mean=True, backward_loss=False,
                                improvement=True, return_individual_results=True)
    data = create_loader_for_simple_dataset(
        dataset_name="WHAMR", separation_task="noisy_reverberant", data_split="test",
        sample_rate=FS, zero_pad=True, timelength=-1.0, root_dirpath=whamr_root)
    scores = []
    for i in range(2):
        item = data[i]
        mix = np.asarray(item[0]).sum(axis=0) if np.asarray(item[0]).ndim == 2 else item[0]
        est = torch.from_numpy(sep.separate(np.asarray(mix)))[None]
        tgt = torch.from_numpy(np.asarray(item[-1])[:2])[None]
        scores += metric(est, tgt, initial_mixtures=torch.from_numpy(
            np.asarray(mix, np.float32))[None, None]).tolist()
    assert abs(summary["si_sdri_mean"] - float(np.mean(scores))) <= 1e-3


@pytest.mark.parametrize("model_type", ["attention_v3", "softmax"])
def test_evaluate_cli_seq_parallel_refuses_as_jax(tmp_path, capsys, model_type):
    with pytest.raises(SystemExit):
        evaluate_main(["--checkpoint", "absent.pt", "--model_type", model_type,
                       "--full_length", "--full_length_mode", "seq_parallel",
                       "--device", "cpu"])
    assert re.search(r"seq_parallel supports model_type in .*attention_v3 falls back",
                     capsys.readouterr().err)


def test_bench_longform_script_runs_tiny():
    """``scripts/torch_bench_longform.py --tiny`` on the CPU: every row's
    keys, finite and exact."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_bench_longform", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "scripts", "torch_bench_longform.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    rows = bench.main(["--tiny", "--device", "cpu", "--seconds", "0.5", "--reps", "1"])
    assert [r["engine"] for r in rows] == ["overlap_add", "seq_parallel"]
    exact = rows[1]
    assert exact["route"] == "fma" and exact["k1_launches"] == 0
    assert exact["fidelity_db"] > 80 and exact["seconds_per_recording"] > 0
