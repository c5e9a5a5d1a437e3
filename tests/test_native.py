"""Native decoder + async loader tests: round-trip against the pure-Python
PNG writer, PGM/PPM, and a synthetic TUM-format sequence."""

import numpy as np
import pytest

from tinyslam.data.png import write_png


@pytest.fixture(scope="module")
def lib():
    from tinyslam.native import get_lib

    try:
        return get_lib()
    except Exception as e:  # pragma: no cover
        pytest.skip(f"native build unavailable: {e}")


def test_png_gray8_roundtrip(tmp_path, lib):
    from tinyslam.native import decode_image

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    p = tmp_path / "g8.png"
    write_png(p, img)
    out = decode_image(p)
    np.testing.assert_array_equal(out, img)


def test_png_rgb8_roundtrip(tmp_path, lib):
    from tinyslam.native import decode_image

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (33, 57, 3), dtype=np.uint8)
    p = tmp_path / "rgb.png"
    write_png(p, img)
    out = decode_image(p)
    np.testing.assert_array_equal(out, img)


def test_png_gray16_roundtrip(tmp_path, lib):
    from tinyslam.native import decode_image

    rng = np.random.default_rng(2)
    img = rng.integers(0, 65536, (24, 31), dtype=np.uint16)
    p = tmp_path / "g16.png"
    write_png(p, img)
    out = decode_image(p)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, img)


def test_pgm_roundtrip(tmp_path, lib):
    from tinyslam.native import decode_image

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (20, 30), dtype=np.uint8)
    p = tmp_path / "img.pgm"
    with open(p, "wb") as f:
        f.write(b"P5\n# comment\n30 20\n255\n")
        f.write(img.tobytes())
    out = decode_image(p)
    np.testing.assert_array_equal(out, img)


def test_decode_missing_file(tmp_path, lib):
    from tinyslam.native import decode_image

    with pytest.raises(IOError):
        decode_image(tmp_path / "nope.png")


def test_frame_loader_order_and_content(tmp_path, lib):
    from tinyslam.native import FrameLoader

    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (16, 24), dtype=np.uint8) for _ in range(20)]
    paths = []
    for i, im in enumerate(imgs):
        p = tmp_path / f"f{i:03d}.png"
        write_png(p, im)
        paths.append(p)
    loader = FrameLoader(paths, capacity=4, threads=3)
    got = list(loader)
    assert len(got) == 20
    for a, b in zip(got, imgs):
        np.testing.assert_array_equal(a, b)


def test_tum_sequence(tmp_path, lib):
    from tinyslam.data.tum import TumSequence

    rng = np.random.default_rng(5)
    (tmp_path / "rgb").mkdir()
    rgb_lines = ["# comment"]
    imgs = []
    for i in range(5):
        im = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
        write_png(tmp_path / "rgb" / f"{i}.png", im)
        rgb_lines.append(f"{100.0 + i*0.033:.4f} rgb/{i}.png")
        imgs.append(im)
    (tmp_path / "rgb.txt").write_text("\n".join(rgb_lines))
    (tmp_path / "groundtruth.txt").write_text(
        "\n".join(
            f"{100.0 + i*0.033:.4f} {0.1*i} 0 0 0 0 0 1" for i in range(5)
        )
    )
    seq = TumSequence.open(tmp_path)
    assert len(seq.rgb) == 5
    assert len(seq.groundtruth) == 5
    frames = list(seq.frames(capacity=2, threads=2))
    assert len(frames) == 5
    np.testing.assert_array_equal(frames[3][1], imgs[3])
    # Identity quaternion -> camera at (0.1*i, 0, 0).
    pos = seq.gt_positions()
    np.testing.assert_allclose(pos[:, 0], 0.1 * np.arange(5), atol=1e-6)


def test_euroc_sequence(tmp_path, lib):
    from tinyslam.data.euroc import EurocSequence

    rng = np.random.default_rng(6)
    cam = tmp_path / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    rows = ["#timestamp [ns],filename"]
    for i in range(4):
        im = rng.integers(0, 256, (10, 14), dtype=np.uint8)
        write_png(cam / "data" / f"{i}.png", im)
        rows.append(f"{int(1e9*(5+i*0.05))},{i}.png")
    (cam / "data.csv").write_text("\n".join(rows))
    seq = EurocSequence.open(tmp_path)
    assert len(seq.cam0) == 4
    frames = list(seq.frames())
    assert len(frames) == 4 and frames[0][1].shape == (10, 14)
