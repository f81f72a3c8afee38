"""The native libraries: rebuilt for the host they run on; the
first-party library links no third-party code; libavcodec is found and
opened at run time by the pixel library alone."""

import os
import subprocess
import sys


class TestNativeBuild:
    """The native libraries are rebuilt for the host they run on, and
    the first-party library links no third-party code."""

    def _csrc(self, tmp_path, key="k1"):
        from cova_tpu import codec

        d = tmp_path / "csrc"
        d.mkdir(parents=True)
        (d / "a.cc").write_text("// src\n")
        (d / ".build_key").write_text(key)
        for lib in (codec._LIB_PATH.name, codec._PIX_LIB_PATH.name):
            (d / lib).write_bytes(b"")
        return d

    def test_current_build_needs_nothing(self, tmp_path):
        from cova_tpu.codec import build_plan

        d = self._csrc(tmp_path)
        os.utime(d / "a.cc", (1, 1))
        assert build_plan(d, "k1") == (False, False)

    def test_other_host_cleans_and_builds(self, tmp_path):
        from cova_tpu.codec import build_plan

        d = self._csrc(tmp_path)
        os.utime(d / "a.cc", (1, 1))
        assert build_plan(d, "k2") == (True, True)
        (d / ".build_key").unlink()
        assert build_plan(d, "k1") == (True, True)

    def test_fresh_checkout_builds_without_clean(self, tmp_path):
        from cova_tpu.codec import build_plan

        d = tmp_path / "csrc"
        d.mkdir()
        (d / "a.cc").write_text("// src\n")
        assert build_plan(d, "k1") == (False, True)
        (d / "a.o").write_bytes(b"")  # built, but for which host?
        assert build_plan(d, "k1") == (True, True)

    def test_newer_source_or_missing_lib_builds(self, tmp_path):
        from cova_tpu import codec
        from cova_tpu.codec import build_plan

        d = self._csrc(tmp_path)
        os.utime(d / codec._LIB_PATH.name, (1, 1))
        assert build_plan(d, "k1") == (False, True)
        d = self._csrc(tmp_path / "x")
        os.utime(d / "a.cc", (1, 1))
        (d / codec._PIX_LIB_PATH.name).unlink()
        assert build_plan(d, "k1") == (False, True)

    def test_host_key_is_recorded_and_stable(self):
        from cova_tpu import codec

        codec.lib()
        key = codec.host_build_key()
        assert key == codec.host_build_key() and len(key) == 64
        assert codec._KEY_PATH.read_text() == key

    def test_codec_library_links_no_ffmpeg(self):
        from cova_tpu import codec

        codec.lib()
        out = subprocess.run(["ldd", str(codec._LIB_PATH)],
                             capture_output=True, text=True).stdout
        assert "libav" not in out
        pix = subprocess.run(["ldd", str(codec._PIX_LIB_PATH)],
                             capture_output=True, text=True).stdout
        assert "libav" not in pix  # opened at run time, not linked

    def test_libavcodec_found_and_loaded(self):
        from cova_tpu.codec import find_libavcodec, pixel_lib

        assert find_libavcodec() is not None
        pixel_lib()

    def test_pixdec_load_reports_failure(self):
        from cova_tpu import codec

        codec.lib()
        # A process that already loaded libavcodec keeps it, so probe
        # the error path in a fresh one.
        code = (
            "import ctypes, sys; p = ctypes.CDLL(sys.argv[1]); "
            "e = ctypes.create_string_buffer(256); "
            "rc = p.cova_pixdec_load(b'/nonexistent/libavcodec.so', e, 256); "
            "print(rc, e.value.decode())"
        )
        out = subprocess.run([sys.executable, "-c", code,
                              str(codec._PIX_LIB_PATH)],
                             capture_output=True, text=True, timeout=60)
        rc, msg = out.stdout.split(" ", 1)
        assert rc == "-1" and "cannot open libavcodec" in msg
