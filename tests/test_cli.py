"""CLI tests: the app shell must actually wire its flags into the renderer
(the reference wires its worker pool into the app, renderer.rs:34-69 via
main.rs:87 -- our --dp flag is the analogue and regressed silently in round
2 because nothing drove the CLI).
"""

import os
import struct
import sys
import zlib

import numpy as np
import pytest

from paths_tpu import cli as CLI
from paths_tpu import render as R


@pytest.fixture()
def capture_render(monkeypatch):
    """Wrap render_image, recording the kwargs the CLI passes it."""
    seen = {}
    real = R.render_image

    def wrapper(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(R, "render_image", wrapper)
    return seen


def test_cli_dp_passes_mesh(tmp_path, capture_render):
    out = tmp_path / "out.png"
    CLI.main([
        "--cpu", "--dp", "2", "--stress", "8", "--spp", "1",
        "--size", "32x8", "-o", str(out),
    ])
    mesh = capture_render.get("mesh")
    assert mesh is not None, "--dp must hand render_image the device mesh"
    assert mesh.devices.size == 2
    assert os.path.exists(out)


def test_cli_default_is_single_device(tmp_path, capture_render):
    out = tmp_path / "out.png"
    CLI.main([
        "--cpu", "--stress", "8", "--spp", "1",
        "--size", "32x8", "-o", str(out),
    ])
    assert capture_render.get("mesh") is None


def test_cli_dp_matches_single_device(tmp_path, capture_render):
    """A --dp render must produce the same image as the default path (RNG is
    a pure function of (pixel, sample); sharding cannot change results)."""
    out1 = tmp_path / "a.png"
    out2 = tmp_path / "b.png"
    common = ["--cpu", "--stress", "8", "--spp", "2", "--size", "32x8"]
    CLI.main(common + ["-o", str(out1)])
    CLI.main(common + ["--dp", "2", "-o", str(out2)])
    np.testing.assert_array_equal(_read_png(out1), _read_png(out2))


def _read_png(path):
    """Decode the 8-bit RGB, filter-0 PNGs that write_png produces."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, colour) == (8, 2)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_write_png_roundtrip(tmp_path):
    from paths_tpu.math.colour import to_bytes_np

    img = np.random.default_rng(0).uniform(0, 2, (5, 7, 3))
    R.write_png(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(_read_png(tmp_path / "x.png"), to_bytes_np(img))


def test_cli_renders_scene_without_yaml_or_pil(tmp_path, monkeypatch):
    """The main path needs neither PyYAML nor Pillow: block both and render
    a bundled scene through the CLI."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    scene = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "scenes", "env_demo.yml")
    out = tmp_path / "env.png"
    CLI.main(["--cpu", scene, "--spp", "1", "--size", "16x8",
              "--max-bounces", "2", "--check", "-o", str(out)])
    img = _read_png(out)
    assert img.shape == (8, 16, 3) and img.max() > 0


def test_cli_refuses_cpu_without_flag(tmp_path):
    """Without a GPU the CLI stops instead of quietly rendering on the CPU;
    --cpu is the explicit way to do that."""
    with pytest.raises(SystemExit, match="--cpu"):
        CLI.main(["--stress", "8", "--spp", "1", "--size", "32x8",
                  "-o", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


def test_cli_native_cpu_backend(tmp_path):
    """--native-cpu renders through the C++ tracer end-to-end."""
    from paths_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    out = tmp_path / "native.png"
    CLI.main([
        "--cpu", "--native-cpu", "--stress", "8", "--spp", "2",
        "--size", "32x8", "-o", str(out),
    ])
    assert os.path.exists(out)
