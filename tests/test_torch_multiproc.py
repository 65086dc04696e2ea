"""A real two-process run of the port's mesh paths: tools/
torch_multiproc_smoke.py spawns 2 processes that join a gloo group, each with
4 cpu slots, and runs the focr, prop and ncc mesh paths over the global
8-slot mesh, asserting bit parity with the local single-slot engines on
every process. The in-process meshes of tests/test_torch_parallel.py cannot
catch cross-process faults (a block only another process holds, the
all-gathers' shapes and order, the packed hits on the wire): this one runs
them. Counterpart of tests/test_multihost.py."""

import os
import subprocess
import sys

import pytest

TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                    "torch_multiproc_smoke.py")


@pytest.fixture(scope="module")
def run():
    env = {k: v for k, v in os.environ.items()
           if k not in ("FOCR_TORCH_MESH_DEVICES", "FOCR_TORCH_DISTRIBUTED")}
    return subprocess.run([sys.executable, TOOL, "--device", "cpu", "--corpus", "small"],
                          capture_output=True, text=True, timeout=400, env=env)


def test_two_process_mesh_paths_match_local(run):
    assert run.returncode == 0, (
        f"multiproc smoke failed rc={run.returncode}\n"
        f"stdout:\n{run.stdout[-4000:]}\nstderr:\n{run.stderr[-4000:]}"
    )
    assert "multiproc smoke rcs=[0, 0]" in run.stdout


@pytest.mark.parametrize("rank", [0, 1])
def test_every_process_holds_the_whole_result(run, rank):
    assert f"[p{rank}] multiproc smoke OK (small corpus, 4 slots on cpu, 8 in the mesh)" in run.stdout


def test_env_route_joins_the_group_and_the_cli_prints_every_page(tmp_path, mono_font_path):
    """FOCR_TORCH_DISTRIBUTED=1 with torch's MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK: two `python -m focr_tpu_torch.cli.ncc` processes,
    two cpu slots each, print the same stdout as one process with --mesh
    off."""
    import socket

    import numpy as np

    from focr_tpu.fonts.ft import Face
    from focr_tpu.io.synth import synthesize_page
    from focr_tpu.models.types import DecodeOptions, RenderOptions
    from focr_tpu_torch.io.images import save_gray

    face = Face(mono_font_path)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    paths = []
    for i, t in enumerate(("AB01ab", "ba10BA", "b0A1", "AAb")):
        paths.append(str(tmp_path / f"{i}.pgm"))
        save_gray(paths[-1], synthesize_page(face, [t], dopts, RenderOptions(size=11.0),
                                             "AB01ab", (64, 128)))
    repo = os.path.dirname(os.path.dirname(TOOL))
    argv = [sys.executable, "-m", "focr_tpu_torch.cli.ncc", "-i", *paths, "-f", mono_font_path,
            "-t", "11", "-a", "AB01ab", "--x-bits", "1", "--device", "cpu"]
    base = {k: v for k, v in os.environ.items()
            if k not in ("FOCR_TORCH_MESH_DEVICES", "FOCR_TORCH_DISTRIBUTED")}
    want = subprocess.run([*argv, "--mesh", "off"], capture_output=True, text=True, timeout=300,
                          env=base, cwd=repo, check=True).stdout
    assert want.splitlines() == ["AB01ab", "ba10BA", "b0A1", "AAb"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=repo,
                         env={**base, "FOCR_TORCH_DISTRIBUTED": "1", "MASTER_ADDR": "127.0.0.1",
                              "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": str(r),
                              "FOCR_TORCH_MESH_DEVICES": "cpu,cpu"})
        for r in range(2)
    ]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o for o, _ in outs] == [want, want]
    assert np.all([len(o) > 0 for o, _ in outs])


@pytest.mark.parametrize("rank", [0, 1])
def test_every_process_decodes_glyph_rows_that_span_processes(run, rank):
    """The smoke's spanning meshes (1 slot a process at 2 glyph shards, 3 at
    2, 4 at 8) ran on every process: its ids, white flags and lines equal
    its local unsharded decode (the tool asserts them before this line)."""
    import json

    lines = [json.loads(ln)["multiproc"] for ln in run.stdout.splitlines()
             if ln.startswith('{"multiproc"')]
    mine = [d for d in lines if d["rank"] == rank]
    assert len(mine) == 1 and set(mine[0]["spanning_slot_launches"]) == {"1x2", "3x2", "4x8"}


def test_env_route_focr_glyph_rows_span_processes(tmp_path, mono_font_path, capsys):
    """Two `python -m focr_tpu_torch.cli.focr` processes joined by
    FOCR_TORCH_DISTRIBUTED=1, one cpu slot each, --glyph-shards 2: the one
    glyph row spans both, and each prints the stdout of --mesh off and of
    focr_tpu's focr CLI (on its 8-device mesh at 2 glyph shards). The port
    used to refuse this mesh (a glyph group had to lie inside one process)."""
    import socket

    from focr_tpu.cli.focr import main as jax_main
    from focr_tpu.fonts.ft import Face
    from focr_tpu.io.synth import synthesize_page
    from focr_tpu.models.types import FOCR_DEFAULT_ALPHABET, DecodeOptions, RenderOptions
    from focr_tpu_torch.io.images import save_gray

    face = Face(mono_font_path)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=120)
    paths = []
    for i, t in enumerate((["AB01", "xyz+/="], ["Q", "k=7"], ["ba10BA"])):
        paths.append(str(tmp_path / f"{i}.pgm"))
        save_gray(paths[-1], synthesize_page(face, t, dopts, RenderOptions(size=11.0),
                                             FOCR_DEFAULT_ALPHABET, (64, 140)))
    grid = ["-f", mono_font_path, "-t", "11", "-x", "5", "-y", "6", "-w", "120",
            "--line-height", "13", "--line-advance", "15"]
    repo = os.path.dirname(os.path.dirname(TOOL))
    argv = [sys.executable, "-m", "focr_tpu_torch.cli.focr", "-i", *paths, *grid,
            "--device", "cpu"]
    base = {k: v for k, v in os.environ.items()
            if k not in ("FOCR_TORCH_MESH_DEVICES", "FOCR_TORCH_DISTRIBUTED")}
    want = subprocess.run([*argv, "--mesh", "off"], capture_output=True, text=True, timeout=300,
                          env=base, cwd=repo, check=True).stdout
    assert "AB01" in want and "k=7" in want
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen([*argv, "--glyph-shards", "2"], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, cwd=repo,
                         env={**base, "FOCR_TORCH_DISTRIBUTED": "1", "MASTER_ADDR": "127.0.0.1",
                              "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": str(r),
                              "FOCR_TORCH_MESH_DEVICES": "cpu"})
        for r in range(2)
    ]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o for o, _ in outs] == [want, want]
    assert jax_main(["-i", *paths, *grid, "--glyph-shards", "2"]) == 0
    assert capsys.readouterr().out == want
