"""The port's multi-process scale-out on the CPU (mirror of tests/test_multihost.py).

The mesh helpers over mock devices; ``maybe_init_distributed`` without its
environment; and a real job of two processes over a localhost ``gloo``
group (run in tier 1 at this size, each worker under its own timeout):
each rank samples its own batch of 2 (seed + 7919 * rank) over a mesh of 2
CPU entries, one data-parallel step all-reduces the gradients, rank 0
alone writes the checkpoint and ``history.json``, and both ranks restore
it.  The step equals a one-process step over the ranks' batches
concatenated in rank order: params within 1e-6 where the gradient is not
below 1e-6, within the step's lr there (tests/torch_train_parity.py).

Run as a script, this file is one rank of that job (``worker``).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(features=8, n_body53=1, n_light=1, n_tail53=1)
WORKER_TIMEOUT_S = 120


@dataclasses.dataclass(frozen=True)
class Dev:
    process_index: int
    id: int


def test_dcn_mesh_single_process_fallback():
    """One process: the DCN-aware mesh has make_mesh's entries; the hybrid mesh is (1, n) with named tiers."""
    from image_enhance_keras_tpu_torch.parallel import make_dcn_mesh, make_hybrid_mesh, make_mesh

    m = make_dcn_mesh(devices=["cpu"] * 8)
    assert m.axis_names == ("data",) and m.devices.size == 8
    assert m.local_devices() == make_mesh(8, devices=["cpu"] * 8).local_devices()
    h = make_hybrid_mesh(devices=["cpu"] * 8)
    assert h.axis_names == ("dcn", "data") and h.devices.shape == (1, 8)


def test_host_major_order_with_mock_devices():
    from image_enhance_keras_tpu_torch.parallel.mesh import host_major_order, make_dcn_mesh, make_hybrid_mesh

    devs = [Dev(1, 2), Dev(0, 3), Dev(1, 0), Dev(0, 1)]
    assert [(d.process_index, d.id) for d in host_major_order(devs)] == [(0, 1), (0, 3), (1, 0), (1, 2)]
    assert [(d.process_index, d.id) for d in make_dcn_mesh(devices=devs).devices.flat] == \
        [(0, 1), (0, 3), (1, 0), (1, 2)]
    h = make_hybrid_mesh(devices=devs)
    assert h.devices.shape == (2, 2) and [d.process_index for d in h.devices[1]] == [1, 1]
    with pytest.raises(ValueError, match="unequal device counts"):
        make_hybrid_mesh(devices=[Dev(0, 0), Dev(0, 1), Dev(0, 2), Dev(1, 0)])


def test_maybe_init_distributed_noop_without_env(monkeypatch):
    from image_enhance_keras_tpu_torch.parallel import maybe_init_distributed

    for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_init_distributed("cpu") is False
    assert not torch.distributed.is_initialized()


def _images():
    return [np.random.default_rng(s).integers(0, 256, (40, 40, 3), dtype=np.uint8) for s in range(3)]


def _config(ckpt):
    from image_enhance_keras_tpu_torch.utils.config import Config

    return Config(model="didbl", model_kwargs=NARROW, batch_size=2, lr_patch=6, steps_per_epoch=1, epochs=1,
                  checkpoint_dir=ckpt, monitor="val_psnr")


def worker(rank: int, world: int, port: int, ckpt: str, out: str) -> int:
    """One rank: join the gloo group, one data-parallel epoch of one step,
    restore rank 0's checkpoint; rank 0 writes the params to ``out``."""
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)  # beside the test run's other workers, one core each
    from image_enhance_keras_tpu_torch.parallel import make_mesh, maybe_init_distributed
    from image_enhance_keras_tpu_torch.train.trainer import Trainer

    os.environ.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}", JAX_NUM_PROCESSES=str(world),
                      JAX_PROCESS_ID=str(rank))
    assert maybe_init_distributed("cpu", timeout_s=WORKER_TIMEOUT_S)
    dist = torch.distributed
    assert dist.get_backend() == "gloo" and dist.get_world_size() == world and dist.get_rank() == rank
    mesh = make_mesh(2, devices=["cpu"] * 2)
    t = Trainer(_config(ckpt), _images(), mesh=mesh)
    hist = t.fit(val_steps=1)
    trained = {k: v.clone() for k, v in t.state.params().items()}
    again = Trainer(_config(ckpt), _images(), mesh=mesh)
    assert again.resume() and again.state.step == 1
    assert all(torch.equal(again.state.params()[k], v) for k, v in trained.items())
    if rank == 0:
        torch.save({"params": trained, "loss": hist["loss"][0]}, out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"MULTIHOST_OK rank={rank} loss={hist['loss'][0]:.6f}", flush=True)
    return 0


def test_two_process_gloo_step_checkpoint_restore(tmp_path):
    from image_enhance_keras_tpu_torch.data.pipeline import PatchSampler
    from image_enhance_keras_tpu_torch.train.trainer import Trainer
    from tests.torch_train_parity import G_FLOOR, PARAM_ATOL

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ckpt, out = str(tmp_path / "ck"), str(tmp_path / "rank0.pt")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_COORDINATOR", "COORDINATOR", "JAX_NUM_P",
                                                                      "JAX_PROCESS"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), "2", str(port), ckpt, out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
             for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a gloo worker timed out")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "MULTIHOST_OK" in log, f"rank {r}:\n{log[-3000:]}"
    # rank 0 alone wrote the checkpoint and the history, one epoch
    assert json.loads((tmp_path / "ck" / "history.json").read_text())["epoch"] == [1]
    assert json.loads((tmp_path / "ck" / "index.json").read_text())["epochs"][0]["epoch"] == 1
    got = torch.load(out)
    # one process over the global batch: the ranks' batches in rank order
    one = Trainer(_config(str(tmp_path / "one")), _images(), device="cpu")
    batch = np.concatenate([PatchSampler(_images(), hr_patch=24, batch_size=2, seed=7919 * r).sample()
                            for r in range(2)])
    _, m = one.train_step(one.state, one._batch(batch))
    grad = {k: p.grad.numpy() for k, p in one.state.opt.params.items()}
    assert abs(float(m["loss"]) - got["loss"]) <= 1e-5 * abs(float(m["loss"]))
    for k, v in one.state.params().items():
        d = np.abs(got["params"][k].numpy() - v.numpy())
        floor = np.abs(grad[k]) < G_FLOOR
        assert d[~floor].max(initial=0.0) <= PARAM_ATOL, (k, d[~floor].max())
        assert d[floor].max(initial=0.0) <= 1e-4, k


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
