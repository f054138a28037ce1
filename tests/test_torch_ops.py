"""PyTorch port (sudo_rm_rf_tpu_torch.ops) against the JAX ops, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. fp32
results agree to float rounding (rtol 1e-5, atol 1e-6); bf16 ones to a bf16
ulp or two (see test_glob_ln_bf16).
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu import ops as jops
from sudo_rm_rf_tpu.ops import pad as jpad
from sudo_rm_rf_tpu_torch import ops as tops
from sudo_rm_rf_tpu_torch.ops import pad as tpad
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_glob_ln_fp32():
    x, g, b = _rand((2, 6, 50), 0, 3.0, 1.0), _rand(6, 1), _rand(6, 2)
    want = jops.glob_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = tops.glob_ln(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    _close(got.numpy(), want)


def test_glob_ln_bf16():
    """The low-precision branch: fp32 statistics, folded scale/shift applied
    in bf16. The two frameworks round the bf16 multiply-add at different
    places, so results agree to a bf16 ulp or two (2**-7 relative)."""
    x, g, b = _rand((2, 6, 50), 3, 3.0, 1.0), _rand(6, 4), _rand(6, 5)
    want = jops.glob_ln(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16),
                        jnp.asarray(b, jnp.bfloat16))
    got = tops.glob_ln(torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16(),
                       torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), rtol=2**-6, atol=2**-6)


@pytest.mark.parametrize("length", [1, 319, 320, 321, 661])
def test_pad_and_unpad(length):
    assert tpad.padded_length(length, 320) == jpad.padded_length(length, 320)
    x = _rand((2, 1, length), length)
    want = jops.pad_to_multiple(jnp.asarray(x), 320)
    got = tops.pad_to_multiple(torch.from_numpy(x), 320)
    _close(got.numpy(), want, rtol=0, atol=0)
    back = tops.unpad_to_length(got, length)
    _close(back.numpy(), jops.unpad_to_length(want, length), rtol=0, atol=0)


def test_upsample_nearest_2x():
    x = _rand((2, 3, 7), 6)
    want = jops.upsample_nearest_2x(jnp.asarray(x))
    _close(tops.upsample_nearest_2x(torch.from_numpy(x)).numpy(), want, rtol=0, atol=0)


@pytest.mark.parametrize("stride,padding,groups", [(1, 0, 1), (2, 2, 1), (1, 2, 4), (2, 2, 8)])
def test_conv1d(stride, padding, groups):
    x, w, b = _rand((2, 8, 37), 7), _rand((8, 8 // groups, 5), 8), _rand(8, 9)
    want = jops.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       stride=stride, padding=padding, groups=groups)
    got = tops.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                      stride=stride, padding=padding, groups=groups)
    _close(got.numpy(), want)


def test_conv_transpose1d_decoder_shape():
    """The decoder's transposed conv: k=21, stride 10, pad 10, output_padding 9."""
    x, w = _rand((2, 6, 13), 10), _rand((6, 2, 21), 11)
    want = jops.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), stride=10,
                                 padding=10, output_padding=9)
    got = tops.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w), stride=10,
                                padding=10, output_padding=9)
    assert got.shape == want.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("step", [8, 5])
def test_overlap_and_add(step):
    x = _rand((2, 7, 16), 12)
    want = jops.overlap_and_add(jnp.asarray(x), step)
    _close(tops.overlap_and_add(torch.from_numpy(x), step).numpy(), want)


def test_port_imports_no_jax_and_never_falls_back(tmp_path):
    """In a fresh interpreter, the whole port imports, runs a toy Improved
    and GroupComm forward in every form, separates a tiny wav through
    ``sudo-torch-separate`` with each model type, separates through two
    ``LocalShards`` of the exact long-form engine, trains one epoch through
    ``sudo-torch-train``, exports its msgpack checkpoint through
    ``sudo-torch-export`` and evaluates it on a hierarchical corpus
    (``--dataset AUGMENTED``), serves in bf16 and int8 and runs
    ``sudo-torch-bench`` and the headline bench on the CPU, builds all eight
    SuDoRM-RF model types and a toy DPRNN (forward and one ``radam_cosine``
    step; the CLIs refuse the baselines, naming ROADMAP queue 3),
    separates with ``--model_type causal``, pushes a hop through a
    ``StreamingSeparator`` and runs the streaming bench, trains one MUSDB
    epoch with bf16 uploads through ``sudo-torch-train --train MUSDB``, packs
    its test split into shards and reads them back, reads a preprocessed
    folder and draws a heatmap (if matplotlib is there), without importing
    JAX, any module of the JAX package, joblib, msgpack or flax; asking for
    CUDA where there is none raises. Then a 2-rank torchrun launch trains
    with ``--n_model 2`` and separates with ``--mode seq_parallel`` (within
    1 LSB of one rank), and no rank imports any of those either."""
    code = textwrap.dedent("""
        import os, sys
        import numpy as np
        import torch
        from scipy.io import wavfile
        import sudo_rm_rf_tpu_torch
        from sudo_rm_rf_tpu_torch import convert, data, inference, models, ops
        from sudo_rm_rf_tpu_torch.cli import separate
        from sudo_rm_rf_tpu_torch.convert import jax_params, torch_checkpoint
        from sudo_rm_rf_tpu_torch.data import base
        from sudo_rm_rf_tpu_torch.inference import overlap_add
        from sudo_rm_rf_tpu_torch.models import (
            fast_inference, groupcomm_sudormrf, improved_sudormrf, layers)
        from sudo_rm_rf_tpu_torch.models.fast_inference import (
            GC_IMPLS, groupcomm_forward_fast, improved_forward_fast)
        from sudo_rm_rf_tpu_torch.ops import _build, conv, frame, norm, pad, resample, uconv
        from sudo_rm_rf_tpu_torch import config, losses, train, utils
        from sudo_rm_rf_tpu_torch.cli import args, train as train_cli
        from sudo_rm_rf_tpu_torch.data import libri2mix, loader, setup, synthetic, wham
        from sudo_rm_rf_tpu_torch.train import augment, experiment, trainer
        from sudo_rm_rf_tpu_torch.utils import audio_logging, checkpoint
        from sudo_rm_rf_tpu_torch.inference import StreamingSeparator, streaming
        from sudo_rm_rf_tpu_torch.models import attentive, causal_sudormrf, sudormrf
        import sudo_rm_rf_tpu_torch.bench_streaming as bench_streaming
        from sudo_rm_rf_tpu_torch.data import musdb, preprocessed, shards
        from sudo_rm_rf_tpu_torch.utils import progress, visualization
        from sudo_rm_rf_tpu_torch.inference import sequence_parallel

        hp = dict(out_channels=8, in_channels=16, num_blocks=1, upsampling_depth=2,
                  enc_num_basis=8)
        m = models.get_model("relu", **hp)
        x = torch.randn(1, 1, 100, generator=torch.Generator().manual_seed(0))
        for impl in ("kernel", "fma", "xla"):
            assert improved_forward_fast(m, x, impl=impl).shape == (1, 2, 100)
        gc = models.get_model("groupcomm_v2", **hp, group_size=4)
        for impl in GC_IMPLS:
            assert groupcomm_forward_fast(gc, x, impl=impl).shape == (1, 2, 100)
        tmp = sys.argv[1]
        wav = os.path.join(tmp, "mix.wav")
        wavfile.write(wav, 8000, (np.random.default_rng(0).standard_normal(900)
                                  * 3000).astype(np.int16))
        for name, model, extra in (("relu", m, []), ("groupcomm_v2", gc, [
                "--group_size", "4", "--mixture_consistency", "uniform"])):
            ckpt, out = os.path.join(tmp, f"{name}.pt"), os.path.join(tmp, name)
            torch.save(model.state_dict(), ckpt)
            argv = ["--checkpoint", ckpt, "--model_type", name, "--input", wav,
                    "--out_dir", out, "--device", "cpu", "--chunk_seconds", "0.05",
                    "--batch_chunks", "2", *extra]
            for k, v in hp.items():
                argv += [f"--{k}", str(v)]
            assert separate.main(argv) == 0
            assert os.path.exists(os.path.join(out, "mix_s2.wav"))
        assert uconv.fused_uconv_block.launches == 0
        sp_est = sequence_parallel.SequenceParallelSeparator(
            gc, sequence_parallel.LocalShards(2)).separate(np.zeros(900, np.float32))
        assert sp_est.shape == (2, 900)
        root = synthetic.write_wham_corpus(os.path.join(tmp, "wham"), n_train=2,
                                           n_val=2, seconds=0.25)
        train_argv = ["--train", "WHAM", "--val", "WHAM", "--wham_root", root,
                      "--n_epochs", "1", "-bs", "2", "--audio_timelength", "0.25",
                      "--n_jobs", "1", "-elp", os.path.join(tmp, "logs"),
                      "-clp", os.path.join(tmp, "ckpt"), "--num_blocks", "1",
                      "--out_channels", "8", "--in_channels", "16",
                      "--upsampling_depth", "2", "--enc_num_basis", "8"]
        assert train_cli.main(train_argv + ["--device", "cpu"]) == 0
        # the msgpack checkpoint it saved, exported and evaluated on a
        # hierarchical corpus
        from sudo_rm_rf_tpu_torch.cli import evaluate as evaluate_cli, export as export_cli
        ckpt_dir = os.path.join(tmp, "ckpt", "sudo_tpu_experiment")
        ckpt = os.path.join(ckpt_dir, next(n for n in os.listdir(ckpt_dir)
                                           if n.startswith("best_") and not n.endswith(".json")))
        hp_argv = [a for k, v in hp.items() for a in (f"--{k}", str(v))]
        assert export_cli.main(["--checkpoint", ckpt, "--out", os.path.join(tmp, "e.pt"),
                                *hp_argv]) == 0
        corpus = synthetic.write_hierarchical_corpus(os.path.join(tmp, "hier"), 2, 2, 2, 2,
                                                     2, seconds=0.5)
        assert evaluate_cli.main(["--checkpoint", ckpt, "--dataset", "AUGMENTED",
                                  "--dataset_paths", os.path.join(corpus, "test"),
                                  "--n_samples", "2", "--timelength", "0.25",
                                  "--batch_size", "2", "--bss_filter_taps", "1",
                                  "--device", "cpu", *hp_argv]) == 0
        # reduced precision, int8, the bench CLI and the headline at toy widths
        import sudo_rm_rf_tpu_torch.bench as headline
        from sudo_rm_rf_tpu_torch.cli import bench as bench_cli
        from sudo_rm_rf_tpu_torch.models import quantized
        from sudo_rm_rf_tpu_torch.utils import benchmark
        for cdt in (None, "bfloat16"):
            assert improved_forward_fast(m, x, compute_dtype=cdt).dtype == torch.float32
            assert groupcomm_forward_fast(gc, x, compute_dtype=cdt).dtype == torch.float32
        qp = quantized.quantize_improved_params(m)
        assert quantized.improved_forward_int8(
            qp, torch.randn(2, 1, 400), upsampling_depth=2).shape == (2, 2, 400)
        benchmark.reference_model_zoo = lambda: {"toy": lambda: models.get_model("relu", **hp)}
        bench_argv = ["--models", "toy", "--batch_sizes", "2", "--timelength", "0.05"]
        assert bench_cli.main(bench_argv + ["--device", "cpu"]) == 0
        assert headline.main(["--device", "cpu"], hp=dict(hp, num_sources=2),
                             seconds=0.1, reps=1) == 0
        # the rest of the SuDoRM-RF family, the causal CLI and streaming
        zoo_hp = dict(hp, upsampling_depth=3)
        for name in ("relu", "improved", "softmax", "groupcomm_v2", "causal", "attention",
                     "attention_v2", "attention_v3"):
            extra = {"group_size": 4} if name == "groupcomm_v2" else {}
            model = models.get_model(name, **zoo_hp, **extra)
            with torch.no_grad():
                assert model(x).shape == (1, 2, 100), name
        # a baseline builds, runs and takes one radam_cosine step; the CLIs
        # refuse every baseline, as the JAX package's cannot build one
        from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_remix
        dprnn = models.get_model("dprnn", enc_dim=16, feature_dim=8, hidden_dim=8, layer=1,
                                 segment_size=10)
        with torch.no_grad():
            assert dprnn(x).shape == (1, 2, 100)
        tr = Trainer(dprnn, TrainerConfig(optimizer="radam_cosine", warmup_steps=1,
                                          total_steps=4, loss_clamp=0.0))
        _, m = tr.train_step(tr.init_state(), torch.randn(2, 2, 100),
                             draw_remix(torch.Generator().manual_seed(0), 2, 2))
        assert np.isfinite(float(m["loss"]))
        for name in models.BASELINES:
            try:
                models.check_cli_model_type(name)
            except ValueError as e:
                assert "ROADMAP queue 3" in str(e), e
            else:
                raise SystemExit(f"{name} did not raise")
        causal = models.get_model("causal", **hp)
        ckpt = os.path.join(tmp, "causal.pt")
        torch.save(causal.state_dict(), ckpt)
        argv = ["--checkpoint", ckpt, "--model_type", "causal", "--input", wav,
                "--out_dir", os.path.join(tmp, "causal"), "--device", "cpu",
                "--chunk_seconds", "0.05", "--batch_chunks", "2"]
        for k, v in hp.items():
            argv += [f"--{k}", str(v)]
        assert separate.main(argv) == 0
        assert os.path.exists(os.path.join(tmp, "causal", "mix_s2.wav"))
        sep = StreamingSeparator(causal, hop_samples=40, context_samples=80)
        assert sep.push(np.zeros(40, np.float32)).shape == (2, 40)
        assert bench_streaming.main(["--device", "cpu", "--streams", "1", "--n_hi", "2",
                                     "--hop", "40", "--context", "80"], model_kwargs=hp) == 0
        # MUSDB with bf16 uploads, shards, a preprocessed folder, the utils
        mus = synthetic.write_musdb_corpus(os.path.join(tmp, "musdb"), 2, 1, seconds=1.5)
        assert train_cli.main(["--train", "MUSDB", "--val", "MUSDB", "--musdb_root", mus,
                               "--n_epochs", "1", "-bs", "2", "--audio_timelength", "0.5",
                               "--n_train", "2", "--n_jobs", "1", "--block_impl", "xla",
                               "--upload_dtype", "bfloat16", "-elp",
                               os.path.join(tmp, "mlogs"), "-clp", os.path.join(tmp, "mckpt"),
                               *hp_argv, "--device", "cpu"]) == 0
        test_split = musdb.MusdbDataset(root_dirpath=mus, split="test", sample_rate=8000,
                                        n_channels=1, timelength=0.5)
        packed = shards.ShardedDataset(shards.pack_dataset(test_split, os.path.join(tmp, "sh")))
        assert np.array_equal(packed[0][0], test_split[0])
        from sudo_rm_rf_tpu_torch.prep import hierarchical as prep
        from sudo_rm_rf_tpu_torch.utils import joblib_format
        os.makedirs(os.path.join(tmp, "pre", "utt"))
        joblib_format.dump(np.ones((1, 8), np.float32), os.path.join(tmp, "pre", "utt", "wav"))
        pre = preprocessed.PreprocessedDataset(root_dirpath=os.path.join(tmp, "pre"),
                                               return_items=["wav"])
        assert pre[0][0].shape == (8,)
        assert progress.progress_bar_wrapper(lambda v: v + 1, [1, 2]) == [2, 3]
        visualization.log_masks_and_bases(os.path.join(tmp, "viz"),
                                          encoder_basis=np.ones((4, 1, 3)))
        foreign = sorted(k for k in sys.modules if k.split(".")[0] in (
            "jax", "sudo_rm_rf_tpu", "joblib", "msgpack", "flax"))
        assert not foreign, foreign
        # a 2-rank torchrun launch (gloo on the CPU): --n_model 2 training,
        # then --mode seq_parallel separation one time shard a rank, within
        # 1 LSB of the one-rank CLI; no rank imports JAX either
        import subprocess
        import textwrap
        from sudo_rm_rf_tpu_torch.inference.sequence_parallel import default_halo_frames
        align = 10 * 2 ** hp["upsampling_depth"]
        per = -(-default_halo_frames(1, hp["upsampling_depth"]) * 10 // align) * align
        long_wav = os.path.join(tmp, "long.wav")
        wavfile.write(long_wav, 8000, (np.random.default_rng(1).standard_normal(4 * per)
                                       * 3000).astype(np.int16))
        seq_argv = ["--checkpoint", os.path.join(tmp, "relu.pt"), "--model_type", "relu",
                    "--input", long_wav, "--mode", "seq_parallel", "--device", "cpu", *hp_argv]
        rank_script = os.path.join(tmp, "rank.py")
        with open(rank_script, "w") as fh:
            fh.write(textwrap.dedent('''
                import json, sys
                import torch.distributed as dist
                from sudo_rm_rf_tpu_torch.cli import separate, train
                from sudo_rm_rf_tpu_torch.parallel import launch_group
                argv = json.loads(sys.argv[1])
                with launch_group("cpu") as joined:
                    assert joined and dist.get_world_size() == 2
                    assert train.main(argv["train"]) == 0
                    assert separate.main(argv["separate"]) == 0
                foreign = sorted(k for k in sys.modules if k.split(".")[0] in (
                    "jax", "sudo_rm_rf_tpu", "joblib", "msgpack", "flax"))
                assert not foreign, foreign
                print("RANK-OK")
            '''))
        launch_argv = {"train": train_argv + ["--n_model", "2", "--device", "cpu",
                                              "-clp", os.path.join(tmp, "ckpt2"),
                                              "-elp", os.path.join(tmp, "logs2")],
                       "separate": seq_argv + ["--out_dir", os.path.join(tmp, "seq2")]}
        import json
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", rank_script, json.dumps(launch_argv)],
            capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0 and proc.stdout.count("RANK-OK") == 2, (
            proc.stdout[-3000:] + proc.stderr[-3000:])
        assert separate.main(seq_argv + ["--out_dir", os.path.join(tmp, "seq1")]) == 0
        for s in (1, 2):
            one = wavfile.read(os.path.join(tmp, "seq1", f"long_s{s}.wav"))[1].astype(int)
            two = wavfile.read(os.path.join(tmp, "seq2", f"long_s{s}.wav"))[1].astype(int)
            assert one.shape == two.shape and np.abs(one - two).max() <= 1
        assert any(n.startswith("best_") for n in os.listdir(
            os.path.join(tmp, "ckpt2", "sudo_tpu_experiment")))
        if not torch.cuda.is_available():
            for call in (
                lambda: models.get_model("relu", num_blocks=1, device="cuda"),
                lambda: separate.main(["--checkpoint", "absent.pt", "--input",
                                       "absent.wav", "--device", "cuda"]),
                lambda: train_cli.main(train_argv),  # --device defaults to cuda
                lambda: bench_cli.main(bench_argv),
                lambda: headline.main([]),
                lambda: bench_streaming.main([]),
            ):
                try:
                    call()
                except (RuntimeError, AssertionError):
                    continue
                raise SystemExit("a CUDA request without CUDA did not raise")
        print("PORT-OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "PORT-OK" in proc.stdout, proc.stdout + proc.stderr


@pytest.mark.parametrize("saved", ["state_dict", "module"])
def test_torch_checkpoint_copy_matches_jax_package(tmp_path, saved):
    """The port's own copy of the checkpoint renaming and ``.pt`` loader
    gives what the JAX package's ``convert.torch_checkpoint`` gives."""
    from sudo_rm_rf_tpu.convert import torch_checkpoint as jtc
    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.convert import torch_checkpoint as ttc

    model = models.get_model("relu", out_channels=8, in_channels=16, num_blocks=2,
                             upsampling_depth=2, enc_num_basis=8,
                             generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "m.pt")
    torch.save(model.state_dict() if saved == "state_dict" else model, path)
    sd, attrs = ttc.load_pt_file(path)
    jsd, jattrs = jtc.load_pt_file(path)
    assert attrs == jattrs and list(sd) == list(jsd)
    for key in sd:
        assert torch.equal(sd[key], jsd[key]), key
        assert ttc.torch_key_to_flax_path(key) == jtc.torch_key_to_flax_path(key)
    tree = jtc.state_dict_to_params(sd)
    got = ttc.params_to_state_dict(tree, sd.keys())
    want = jtc.params_to_state_dict(tree, target_keys=sd.keys(), to_torch=True)
    assert sorted(got) == sorted(want)
    for key in got:
        assert torch.equal(got[key], want[key]), key
    with pytest.raises(ValueError, match="no torch key"):
        ttc.params_to_state_dict(tree, list(sd)[1:])
