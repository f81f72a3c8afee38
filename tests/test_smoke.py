"""CPU tests of what runs the system on the GPU: the device check, the
compile-cache location, and chip_smoke.py's phase functions at a tiny
size (the full-size run needs the card; `main()` refuses the CPU)."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


class TestDeviceCheck:
    def test_require_gpu_refuses_cpu(self):
        import jax

        from cova_tpu.device import NoAcceleratorError, require_gpu

        with pytest.raises(NoAcceleratorError, match="no GPU"):
            require_gpu(jax.devices("cpu"))

    def test_describe_names_the_devices(self):
        import jax

        from cova_tpu.device import describe

        d = describe(jax.devices("cpu"))
        assert d == {"platform": "cpu", "kind": jax.devices("cpu")[0].device_kind,
                     "count": len(jax.devices("cpu"))}

    @pytest.mark.parametrize("argv", [[], ["--devices", "4"]])
    def test_smoke_main_refuses_cpu(self, argv, capsys):
        assert chip_smoke.main(argv) == 1
        out = capsys.readouterr()
        assert "no GPU" in out.err
        assert '"ok"' not in out.out

    def test_bench_refuses_cpu(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        p = subprocess.run([sys.executable, str(REPO / "bench.py")],
                           capture_output=True, text=True, env=env,
                           timeout=120)
        assert p.returncode == 1
        assert "no GPU" in p.stderr and p.stdout == ""


def test_main_path_imports_no_optional_package():
    """The pipeline, its oracle, the query layer and the smoke test need
    only JAX, numpy, scipy, optax, chex and einops."""
    code = (
        "import sys; import chip_smoke, examples.run_cova, "
        "cova_tpu.pipeline.cova, cova_tpu.models, cova_tpu.models.bgdet, "
        "cova_tpu.models.train_blobnet, cova_tpu.query.metrics; "
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'flax', 'pandas', 'yaml', 'orbax', 'cv2', 'torch', 'tensorflow'}))"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


class TestCompileCache:
    def test_env_var_wins(self):
        from cova_tpu import compile_cache_dir

        assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"

    def test_default_is_fixed_path_in_checkout(self):
        from cova_tpu import compile_cache_dir

        assert compile_cache_dir({}) == str(REPO / ".jax_cache")
        assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == str(
            REPO / ".jax_cache"
        )

    @pytest.mark.parametrize("env_dir", [None, "custom"])
    def test_import_configures_jax(self, env_dir, tmp_path):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        if env_dir:
            env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
        code = ("import jax, cova_tpu; "
                "print(jax.config.jax_compilation_cache_dir)")
        p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, env=env, cwd=str(REPO), timeout=120)
        assert p.returncode == 0, p.stderr
        want = str(tmp_path / env_dir) if env_dir else str(REPO / ".jax_cache")
        assert p.stdout.strip() == want

    def test_cache_dir_is_gitignored(self):
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


class TestSmokePhases:
    @pytest.fixture(scope="class")
    def record(self):
        return chip_smoke.inputs_record()

    def test_committed_clip_matches_record(self, record):
        chip_smoke.phase_input(REPO / record["clip"], record)

    def test_clip_hash_mismatch_fails(self, record, tmp_path):
        other = tmp_path / "other.mp4"
        other.write_bytes(b"not the clip")
        with pytest.raises(chip_smoke.SmokeFailure, match="sha256"):
            chip_smoke.phase_input(other, record)

    def test_pixel_phase_matches_record(self, record):
        assert chip_smoke.phase_pixels(REPO / record["clip"], record)

    def test_numerics_phase_tiny(self, record):
        import jax

        model, variables, cfg, chunk = chip_smoke.synth_chunk(
            REPO / record["clip"], num_ranges=2, frames=4
        )
        assert chunk.shape == (2, 7, 45, 80, 2)
        cpu = jax.devices("cpu")[0]
        got = chip_smoke.phase_numerics(cpu, cpu, model, variables, cfg,
                                        chunk, lambda m: None)
        assert got["highest"]["max_abs_dprob"] <= chip_smoke.HIGHEST_TOL
        assert got["highest"]["mask_flip_share"] == 0.0
        assert got["boxes"] >= 0

    def test_pipeline_phase_tiny(self, tmp_path):
        res, q, compile_s = chip_smoke.run_synth(
            tmp_path, max_frames=24, batch_frames=4, log=lambda m: None
        )
        assert res.num_frames == 4 * 24
        assert 0.0 <= q.bp_accuracy <= 1.0 and compile_s > 0
        for name in chip_smoke.CSV_NAMES:
            assert (tmp_path / name).exists()
        # A 96-frame cut cannot meet the full-clip bands.
        with pytest.raises(chip_smoke.SmokeFailure, match="outside its band"):
            chip_smoke.check_bands(res, q)

    def test_compare_csvs(self, tmp_path):
        for sub in ("a", "b"):
            (tmp_path / sub).mkdir()
            for name in chip_smoke.CSV_NAMES:
                (tmp_path / sub / name).write_text("x\n")
        assert chip_smoke.compare_csvs(tmp_path / "a", tmp_path / "b") == []
        (tmp_path / "b" / "dnn.csv").write_text("y\n")
        assert chip_smoke.compare_csvs(tmp_path / "a", tmp_path / "b") == ["dnn.csv"]

    def test_bands_are_the_golden_tests(self):
        assert chip_smoke.BANDS == {"bp_accuracy": 0.98, "gc_error": 1.7,
                                    "decode_filter_rate": 0.65,
                                    "inference_filter_rate": 0.98}
        report = json.loads((REPO / "golden" / "synth" / "report.json").read_text())
        assert report["bp_accuracy"] >= chip_smoke.BANDS["bp_accuracy"]


class TestGpu:
    """Run on a GPU host with `python -m pytest tests -m gpu`."""

    @pytest.mark.gpu
    def test_blobnet_gpu_matches_flax_fixture(self, gpu):
        import jax

        from cova_tpu.models.blobnet import BlobNet, BlobNetConfig, load_artifact

        fx = np.load(REPO / "tests" / "data" / "blobnet_flax_fixture.npz")
        x = np.random.default_rng(7).uniform(-1, 1, (2, 4, 45, 80, 4)).astype(
            np.float32)
        _, v, _ = load_artifact(REPO / "artifacts" / "blobnet_synth.npz")
        model = BlobNet(BlobNetConfig(in_channels=4))
        with jax.default_matmul_precision("highest"):
            got = jax.jit(model.apply)(jax.device_put(v, gpu),
                                       jax.device_put(x, gpu))
        assert np.abs(np.asarray(got) - fx["probs_synth4"]).max() <= 1e-4

    @pytest.mark.gpu
    def test_mask_to_boxes_gpu_matches_host(self, gpu):
        import jax

        from cova_tpu.ops.cc import mask_to_boxes
        from cova_tpu.tracker.host import cc_boxes

        masks = np.random.default_rng(3).uniform(size=(64, 45, 80)) < 0.3
        dev = jax.jit(mask_to_boxes, static_argnums=(1, 2))(
            jax.device_put(masks, gpu), 2, 16)
        ltwh, _, valid = cc_boxes(masks, 2, 16)
        np.testing.assert_array_equal(np.asarray(dev.valid), valid)
        np.testing.assert_array_equal(np.asarray(dev.ltwh)[valid], ltwh[valid])
