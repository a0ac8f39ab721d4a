"""The port's data tools against the JAX package's: ``ops/enhancement.py``
(spectral subtraction, the numpy version in float64), the five
``data/audio_tools.py`` tools and their CLI, ``data/convert_to_npz.py``
and ``data/opensmile.py`` (with a fake ``SMILExtract`` on ``PATH``, as
``tests/unit/test_opensmile.py`` runs the JAX one).

Tolerances: ``enhance`` in float64 within rtol 1e-9 of the numpy version
(measured 7.1e-12: the FFTs round differently), its float32 result
within one float32 ulp; every other tool repeats the JAX package's numpy
code, so its files are equal (npz files member by member: the zip
timestamps differ).
"""

import os
import stat

import numpy as np
import pytest
import torch

from idiaptts_tpu.data import audio_tools as jax_tools
from idiaptts_tpu.data import convert_to_npz as jax_convert
from idiaptts_tpu.data.opensmile import OpenSMILELabelGen as JaxSmile
from idiaptts_tpu.ops import audio_io as jax_audio_io
from idiaptts_tpu.ops import enhancement as jax_enhancement
from idiaptts_torch.data import audio_tools, convert_to_npz
from idiaptts_torch.data.opensmile import OpenSMILELabelGen
from idiaptts_torch.ops import enhancement

IDS = ("gen-0001", "gen-0004")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain CPU path is many small ops: one intra-op thread runs it
    faster, above all beside the suite's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _noisy(fixtures_dir, id_name="gen-0001", seed=0):
    raw, fs = jax_audio_io.get_raw(os.path.join(
        fixtures_dir, "database", "wav", id_name + ".wav"))
    rng = np.random.RandomState(seed)
    return (raw + 0.01 * rng.randn(len(raw))).astype(np.float32), fs


def _numpy_float64(noisy, fs, monkeypatch, **kw):
    """The JAX package's ``enhance`` result before its float32 cast."""
    seen = {}
    istft = jax_enhancement._istft

    def capture(*args):
        seen["out"] = istft(*args)
        return seen["out"]

    monkeypatch.setattr(jax_enhancement, "_istft", capture)
    out32 = jax_enhancement.enhance(noisy, fs, **kw)
    return seen["out"], out32


@pytest.mark.parametrize("kw", [dict(), dict(t60=0.5),
                                dict(t60=0.3, dereverb=False),
                                dict(t60=0.8, minimum_gain_db=-20.0)])
def test_enhance_matches_numpy(fixtures_dir, monkeypatch, kw):
    noisy, fs = _noisy(fixtures_dir)
    ref64, ref32 = _numpy_float64(noisy, fs, monkeypatch, **kw)
    got64 = enhancement._enhance(
        torch.as_tensor(noisy.astype(np.float64)), fs, **kw)
    assert got64.dtype == torch.float64 and got64.shape == ref64.shape
    np.testing.assert_allclose(got64.numpy(), ref64, rtol=1e-9, atol=0)
    got32 = enhancement.enhance(noisy, fs, device="cpu", **kw)
    assert got32.dtype == np.float32 and got32.shape == ref32.shape
    np.testing.assert_array_max_ulp(got32, ref32, maxulp=1)


def test_enhance_short_and_long_inputs(monkeypatch):
    """Shorter than a frame, and longer than the 3 s minimum window (the
    window minimum then slides)."""
    rng = np.random.RandomState(1)
    for n, fs in ((300, 16000), (16000 * 4, 16000)):
        x = (0.1 * rng.randn(n)).astype(np.float32)
        ref64, _ = _numpy_float64(x, fs, monkeypatch, t60=0.4)
        got = enhancement._enhance(torch.as_tensor(x.astype(np.float64)),
                                   fs, t60=0.4)
        np.testing.assert_allclose(got.numpy(), ref64, rtol=1e-9, atol=0)


def test_minimum_statistics_matches_numpy():
    P = np.random.RandomState(2).rand(50, 9) ** 2
    for frames in (4, 17, 60):
        np.testing.assert_array_equal(
            enhancement._minimum_statistics(torch.as_tensor(P),
                                            frames).numpy(),
            jax_enhancement._minimum_statistics(P, frames))


def test_enhance_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        enhancement.enhance(np.zeros(100, np.float32), 16000)


def _wav_dir(fixtures_dir):
    return os.path.join(fixtures_dir, "database", "wav")


def _id_list(tmp_path):
    path = tmp_path / "ids.txt"
    path.write_text("\n".join(IDS) + "\n")
    return str(path)


@pytest.mark.parametrize("tool,kw", [
    ("silence_remove", dict(silence_db=-30.0)),
    ("down_sampling", dict(target_fs=8000)),
    ("high_pass_filter", dict(cutoff=100.0, order=201)),
    ("normalize_loudness", dict(target_dbfs=-25.0)),
])
def test_audio_tools_write_the_jax_files(fixtures_dir, tmp_path, tool, kw):
    ids = _id_list(tmp_path)
    getattr(jax_tools, tool)(_wav_dir(fixtures_dir), str(tmp_path / "j"),
                             ids, **kw)
    getattr(audio_tools, tool)(_wav_dir(fixtures_dir), str(tmp_path / "t"),
                               ids, **kw)
    for id_name in IDS:
        a = (tmp_path / "j" / (id_name + ".wav")).read_bytes()
        b = (tmp_path / "t" / (id_name + ".wav")).read_bytes()
        assert a == b and len(a) > 44


def test_noise_reduction_tool(fixtures_dir, tmp_path):
    """Through ``main``, on the CPU: PCM within one step of the JAX
    tool's (one float32 ulp before quantisation)."""
    ids = _id_list(tmp_path)
    jax_tools.noise_reduction(_wav_dir(fixtures_dir), str(tmp_path / "j"),
                              ids, t60=0.5)
    audio_tools.main(["noise_reduction", "--dir_wav",
                      _wav_dir(fixtures_dir), "--dir_out",
                      str(tmp_path / "t"), "--id_list", ids, "--t60", "0.5",
                      "--device", "cpu"])
    for id_name in IDS:
        a, fs_a = jax_audio_io.get_raw(str(tmp_path / "j" / (id_name
                                                             + ".wav")))
        b, fs_b = jax_audio_io.get_raw(str(tmp_path / "t" / (id_name
                                                             + ".wav")))
        assert fs_a == fs_b and a.shape == b.shape
        assert np.abs(a - b).max() <= 1.0 / 32768.0


def test_audio_tools_main_matches_jax(fixtures_dir, tmp_path, monkeypatch):
    ids = _id_list(tmp_path)
    args = ["normalize_loudness", "--dir_wav", _wav_dir(fixtures_dir),
            "--id_list", ids, "--target_dbfs", "-18"]
    monkeypatch.setattr("sys.argv", ["audio_tools"] + args + [
        "--dir_out", str(tmp_path / "j")])
    jax_tools.main()
    audio_tools.main(args + ["--dir_out", str(tmp_path / "t")])
    for id_name in IDS:
        assert (tmp_path / "j" / (id_name + ".wav")).read_bytes() == \
            (tmp_path / "t" / (id_name + ".wav")).read_bytes()


def _npz(path):
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


@pytest.mark.parametrize("ext,dim,key", [("lf0", None, None),
                                         ("mcep", 20, "mgc"),
                                         ("mcep", 7, None)])
def test_convert_to_npz_matches_jax(fixtures_dir, tmp_path, ext, dim, key):
    """Raw float32 files made from the fixture features (1-D lf0, 20-wide
    mcep; width 7 does not divide, so those files are skipped)."""
    src = tmp_path / "raw"
    src.mkdir()
    for id_name in IDS:
        feats = _npz(os.path.join(fixtures_dir, "WORLD",
                                  "lf0" if ext == "lf0" else "mcep20",
                                  id_name + ".npz"))
        np.asarray(next(iter(feats.values())), np.float32).tofile(
            str(src / (id_name + "." + ext)))
    written = {}
    for name, mod in (("j", jax_convert), ("t", convert_to_npz)):
        written[name] = mod.convert_dir(str(src), ext, dim=dim, key=key,
                                        dir_out=str(tmp_path / name))
    assert [os.path.basename(p) for p in written["t"]] == \
        [os.path.basename(p) for p in written["j"]]
    assert len(written["t"]) == (0 if dim == 7 else len(IDS))
    for a, b in zip(written["j"], written["t"]):
        got, want = _npz(b), _npz(a)
        assert sorted(got) == sorted(want) == [key or ext]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_convert_to_npz_main(tmp_path):
    src = tmp_path / "raw"
    src.mkdir()
    np.arange(12, dtype=np.float32).tofile(str(src / "u.feat"))
    convert_to_npz.main(["-d", str(src), "-e", "feat", "--dim", "3",
                         "-o", str(tmp_path / "out")])
    np.testing.assert_array_equal(_npz(str(tmp_path / "out" / "u.npz"))[
        "feat"], np.arange(12, dtype=np.float32).reshape(4, 3))


FAKE_SMILE = r"""#!/usr/bin/env python
import sys

args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
wav, out = args["-I"], args["-csvoutput"]
seed = sum(ord(c) for c in wav.rsplit("/", 1)[-1])
with open(out, "w") as f:
    for t in range(4):
        row = [seed % 10 + t, t * 0.5, float(seed % 3)]
        f.write(";".join(str(v) for v in row) + "\n")
"""


@pytest.fixture
def fake_smile(tmp_path, monkeypatch):
    binary = tmp_path / "bin" / "SMILExtract"
    binary.parent.mkdir()
    binary.write_text(FAKE_SMILE)
    binary.chmod(binary.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(binary.parent) + os.pathsep
                       + os.environ["PATH"])
    config = tmp_path / "egemaps.conf"
    config.write_text("; fake config\n")
    return str(config)


def test_opensmile_matches_jax(fake_smile, tmp_path):
    dir_wav = tmp_path / "wav"
    dir_wav.mkdir()
    ids = ["utt1", "utt2", "utt3"]
    for id_name in ids:
        (dir_wav / (id_name + ".wav")).write_bytes(b"RIFF")
    outs = {}
    for name, cls in (("j", JaxSmile), ("t", OpenSMILELabelGen)):
        dir_out = tmp_path / name
        dir_out.mkdir()
        cfg = cls.Config(name="egemaps", directory=str(dir_out),
                         config_file=fake_smile)
        labels, (mean, std) = cls(cfg).gen_data(
            str(dir_wav), dir_out=str(dir_out), id_list=ids,
            return_dict=True)
        outs[name] = (cfg, labels, mean, std, dir_out)
    (_, lab_j, mean_j, std_j, dir_j), (cfg_t, lab_t, mean_t, std_t,
                                       dir_t) = outs["j"], outs["t"]
    for id_name in ids:
        np.testing.assert_array_equal(lab_t[id_name], lab_j[id_name])
    np.testing.assert_array_equal(mean_t, mean_j)
    np.testing.assert_array_equal(std_t, std_j)
    assert sorted(os.listdir(dir_t)) == sorted(os.listdir(dir_j))
    for f in os.listdir(dir_j):
        got, want = _npz(str(dir_t / f)), _npz(str(dir_j / f))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    reader = cfg_t.create_reader()
    sample = reader["utt1"]["egemaps"]
    np.testing.assert_allclose(reader.postprocess_sample(sample),
                               lab_t["utt1"], atol=1e-4)


def test_opensmile_missing_binary_raises(tmp_path):
    with pytest.raises(RuntimeError, match="not found on PATH"):
        OpenSMILELabelGen.extract_features(
            str(tmp_path / "a.wav"), "conf",
            smile_binary="definitely-not-a-binary")
