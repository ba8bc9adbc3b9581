"""render_sharded over two processes of a gloo process group on the CPU.

Two processes with four ``torch.device("cpu")`` entries each render a
(4, 2) mesh twice: host-major (``make_multihost_mesh(n_hosts=None,
sample_per_host=2)``: every sample group inside one process, only the
gather crosses) and interleaved (every sample group spans both processes,
so the partial bands cross too). Each process renders only its own four
shards, and each gathered frame equals the single-process 8-entry frame
bit for bit, for the lax and the megakernel engines. The group is killed,
and the test fails, after 120 s."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_rt_torch.core import rng
from tpu_rt_torch.core.types import demo_scene, make_camera
from tpu_rt_torch.parallel import make_mesh, render_sharded

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
KW = dict(width=32, height=16, spp=8, max_depth=2)
ENGINES = ("lax", "pallas")
LIMIT_S = 120

WORKER = """
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=60))
from tpu_rt_torch.core import rng
from tpu_rt_torch.core.types import demo_scene, make_camera
from tpu_rt_torch.parallel import (group_devices_by_host, make_mesh,
                                   make_multihost_mesh, render_sharded,
                                   sample_groups_are_host_local)

cpu = torch.device("cpu")
mine = [cpu] * 4
pod = make_multihost_mesh(devices=mine, sample_per_host=2)
hosts = group_devices_by_host(mine)
interleaved = make_mesh(4, 2, devices=[d for pair in zip(*hosts)
                                       for d in pair])
assert sample_groups_are_host_local(pod)
assert not sample_groups_are_host_local(interleaved)
scene, cam = demo_scene(device=cpu), make_camera(aspect=2.0, device=cpu)
res = {}
for name, mesh in (("pod", pod), ("interleaved", interleaved)):
    assert mesh.shape == {"tile": 4, "sample": 2}
    for engine in %(engines)r:
        img = render_sharded(scene, cam, rng.key(11, device=cpu), mesh,
                             engine=engine, **%(kw)r)
        res[f"{name}_{engine}"] = img.gather().numpy()
        res[f"{name}_{engine}_shards"] = np.asarray(img.shards)
        res[f"{name}_{engine}_bands"] = np.asarray(sorted(img.bands))
np.savez(out, **res)
dist.destroy_process_group()
"""


def test_two_gloo_processes_equal_the_single_process_frame(tmp_path):
    script = WORKER % {"engines": ENGINES, "kw": KW}
    env = dict(os.environ, PYTHONPATH=str(ROOT), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(tmp_path / "store"),
         str(tmp_path / f"out{r}.npz")], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=LIMIT_S) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the two gloo processes did not finish in {LIMIT_S} s")
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]

    cpu = torch.device("cpu")
    scene, cam = demo_scene(device=cpu), make_camera(aspect=2.0, device=cpu)
    single = {engine: np.asarray(render_sharded(
        scene, cam, rng.key(11, device=cpu),
        make_mesh(4, 2, devices=[cpu] * 8), engine=engine, **KW))
        for engine in ENGINES}
    res = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for engine in ENGINES:
        for r in range(2):
            for name in ("pod", "interleaved"):
                np.testing.assert_array_equal(res[r][f"{name}_{engine}"],
                                              single[engine])
            # host-major: process r owns tiles 2r, 2r + 1 and both of their
            # sample shards; interleaved: sample shard r of every tile
            pod = [tuple(s) for s in res[r][f"pod_{engine}_shards"]]
            assert pod == [(t, s) for t in (2 * r, 2 * r + 1)
                           for s in range(2)]
            inter = [tuple(s) for s in res[r][f"interleaved_{engine}_shards"]]
            assert inter == [(t, r) for t in range(4)]
            assert res[r][f"pod_{engine}_bands"].tolist() == [2 * r,
                                                              2 * r + 1]
        # interleaved rows are reduced on their first entry: process 0's
        assert res[0][f"interleaved_{engine}_bands"].tolist() == [0, 1, 2, 3]
        assert res[1][f"interleaved_{engine}_bands"].tolist() == []
