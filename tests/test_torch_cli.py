"""The port's command-line tool (`python -m pfv_torch`, pfv_torch.cli) with
--device cpu, its stage timer and its device trace. `info` is held line for
line to pfv_tpu.cli's output; decoded frames exact to the scalar reference
decoder."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import pfv_torch
from pfv_torch import runtime, synth
from pfv_torch.cli import main
from pfv_torch.dec import split_packets
from pfv_torch.ops.color import double_plane, yuv_to_rgb
from pfv_torch.utils.profiling import StageTimer, device_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ref_rgb(data: bytes) -> np.ndarray:
    y, u, v = (torch.from_numpy(p) for p in runtime.ref_decode(data)[1:4])
    h, w = y.shape[1:]
    return yuv_to_rgb(y, double_plane(u)[:, :h, :w], double_plane(v)[:, :h, :w]).numpy()


def test_cli_roundtrip(tmp_path, capsys):
    pfv, out = str(tmp_path / "clip.pfv"), str(tmp_path / "out.npy")
    main(["encode", pfv, "--synth", "5", "--size", "64x48", "--quality", "4",
          "--keyframe-every", "3", "--fps", "24", "--device", "cpu"])
    main(["info", pfv])
    main(["decode", pfv, "--output", out, "--device", "cpu", "--threads", "2"])
    main(["bench", pfv, "--runs", "2", "--device", "cpu"])
    main(["verify", pfv, "--device", "cpu"])

    text = capsys.readouterr().out
    assert "encoded 5 frames 64x48 q4" in text
    assert "64x48 @ 24 fps, 4 q-tables" in text
    assert "2 I-frames, 3 P-frames" in text
    assert "decoded 5 frames 64x48" in text and f"wrote {out}" in text
    assert re.search(r"RUN 1: decoded 5 frames in [\d.]+ ms \(\d+ fps\)", text)
    assert "OK: 5 frames, device decode matches scalar decoder" in text

    with open(pfv, "rb") as f:
        data = f.read()
    rgb = np.load(out)
    assert rgb.dtype == np.uint8 and np.array_equal(rgb, ref_rgb(data))
    frames = [synth.synth_yuv_frame(t, 64, 48) for t in range(5)]
    planes = map(np.stack, zip(*frames))
    assert data == pfv_torch.encode_video(*planes, 24, 4, 3, device="cpu")


def test_cli_npy_input_roundtrip(tmp_path):
    src = np.stack([synth.synth_rgb_frame(t, 64, 48) for t in range(4)])
    inp, pfv, out = (str(tmp_path / n) for n in ("in.npy", "c.pfv", "o.npy"))
    np.save(inp, src)
    main(["encode", pfv, "--input", inp, "--quality", "2", "--device", "cpu"])
    main(["decode", pfv, "--output", out, "--device", "cpu"])
    got = np.load(out)
    assert got.shape == src.shape
    mse = np.mean((got.astype(float) - src.astype(float)) ** 2)
    assert 10 * np.log10(255.0**2 / mse) > 18  # 4:2:0 point decimation of noisy texture


@pytest.mark.parametrize("flags", [[], ["--frames"]])
def test_info_prints_what_the_jax_tool_prints(tmp_path, capsys, flags):
    """A stream with a drop frame and an unknown packet, and one cut short
    of its EOF packet."""
    from pfv_tpu.cli import main as jax_main

    info, packets = split_packets(synth.random_stream(64, 48, 6, seed=8, keyframes=3))
    packets = packets[:2] + [(1, b""), (7, b"abc")] + packets[2:]
    whole = synth.container(64, 48, info["qtables"], packets, fps=25)
    for name, data in (("whole.pfv", whole), ("cut.pfv", whole[:-5])):
        path = tmp_path / name
        path.write_bytes(data)
        main(["info", str(path), *flags])
        got = capsys.readouterr().out
        jax_main(["info", str(path), *flags])
        assert got == capsys.readouterr().out
        assert "1 drop frames, 1 unknown" in got
        assert ("EOF present" if name == "whole.pfv" else "EOF MISSING") in got
        assert ("packet    2:  drop" in got) == bool(flags)


def test_verify_reports_a_mismatch(tmp_path, monkeypatch):
    from pfv_torch import dataloader

    path = tmp_path / "v.pfv"
    path.write_bytes(synth.random_stream(64, 48, 4, seed=9, keyframes=2))
    sums = dataloader.decode_video_checksums

    def wrong(*args, **kwargs):
        out = sums(*args, **kwargs)
        out[2, 1] += 1
        return out

    monkeypatch.setattr(dataloader, "decode_video_checksums", wrong)
    with pytest.raises(SystemExit, match=r"MISMATCH at frame/plane indices \[\[2, 1\]\] "
                                         r"\(1 of 12 checksums differ\)"):
        main(["verify", str(path), "--device", "cpu"])


def test_cli_play(tmp_path, capsys):
    pfv = str(tmp_path / "p.pfv")
    main(["encode", pfv, "--synth", "4", "--size", "64x48", "--quality", "6",
          "--keyframe-every", "2", "--fps", "240", "--device", "cpu"])
    main(["play", pfv, "--width", "32", "--max-frames", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "▀" in out
    m = re.search(r"played (\d+) frames @ 240 fps nominal", out)
    assert m and 3 <= int(m.group(1)) <= 4, out[-200:]  # a tick may pump two frames
    main(["play", pfv, "--width", "16", "--max-frames", "6", "--loop", "--device", "cpu"])
    m = re.search(r"played (\d+) frames", capsys.readouterr().out)
    assert m and int(m.group(1)) >= 6  # a 4-frame clip: it looped


def test_cli_errors(tmp_path):
    with pytest.raises(SystemExit, match="no such file"):
        main(["info", str(tmp_path / "missing.pfv")])
    bad = tmp_path / "bad.pfv"
    bad.write_bytes(b"not a pfv stream, only some bytes")
    with pytest.raises(SystemExit, match="pfv-torch: bad PFV header"):
        main(["decode", str(bad), "--output", str(tmp_path / "o.npy"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="unsupported input"):
        main(["encode", str(tmp_path / "x.pfv"), "--input", str(bad), "--device", "cpu"])


@pytest.mark.parametrize("cmd", ["decode", "bench", "verify", "play", "encode"])
def test_default_device_is_cuda_and_nothing_falls_back(tmp_path, cmd):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    pfv = tmp_path / "c.pfv"
    pfv.write_bytes(synth.random_stream(64, 48, 2, seed=1))
    args = {"decode": ["--output", str(tmp_path / "o.npy")],
            "encode": ["--synth", "2", "--size", "64x48"]}.get(cmd, [])
    with pytest.raises((RuntimeError, AssertionError)):
        main([cmd, str(pfv), *args])


def test_module_entry_point(tmp_path):
    pfv = tmp_path / "m.pfv"
    pfv.write_bytes(synth.random_stream(64, 48, 3, seed=1, keyframes=2))
    proc = subprocess.run([sys.executable, "-m", "pfv_torch", "verify", str(pfv),
                           "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0 and proc.stdout.startswith("OK: 3 frames"), proc.stderr


def test_stage_timer():
    import time

    t = StageTimer()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    rep = t.report()
    assert "a" in rep and "2 calls" in rep.replace("    2", "2")
    assert t.counts["a"] == 2 and t.totals["a"] >= 0.01
    assert rep.index(" a:") < rep.index(" b:")  # the longest stage first
    assert StageTimer().report() == ""


def test_stage_timer_takes_encode_video_stages():
    frames = [synth.synth_yuv_frame(t, 64, 48) for t in range(3)]
    t = StageTimer()
    pfv_torch.encode_video(*map(np.stack, zip(*frames)), 30, 3, 2, timer=t, device="cpu")
    assert set(t.counts) == {"h2d upload", "device encode", "d2h fetch", "host mux"}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    data = synth.random_stream(64, 48, 3, seed=1, keyframes=2)
    with device_trace(str(tmp_path / "trace")) as prof:
        pfv_torch.decode_video_rgb(data, device="cpu")
    assert prof is not None
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("index_add" in e.get("name", "") or "aten::" in e.get("name", "")
               for e in events)


def test_top_level_exports():
    for name in ("VideoDataLoader", "decode_many_rgb", "decode_video_rgb_chunks",
                 "encode_video_gops", "encode_video", "decode_video_rgb"):
        assert callable(getattr(pfv_torch, name)) and name in pfv_torch.__all__
    with pytest.raises(AttributeError):
        pfv_torch.nonexistent_thing
