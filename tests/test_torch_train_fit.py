"""The port's Trainer, checkpoints and learn CLI, against the JAX package on the CPU.

``Trainer.fit`` (2 epochs of 2 steps, the same seeds and images, JAX's
initial params carried into the port) gives JAX's history within rtol
1e-4, the same best epoch in ``index.json``, and params and EMA within
1e-6 of JAX's; both write the same files.
A resumed run continues the step and epoch numbering and restores the
optimizer and the EMA.  The port's npz exports load in the JAX package and
give its forward within 3e-5 (fp16: within the JAX test's 5e-4); the
port's engine loads the port's ``latest`` directory; orbax directories are
refused.  ``cli.learn`` trains every zoo model at narrow width on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.train import checkpoints as jax_ckpt
from image_enhance_keras_tpu.train.trainer import Trainer as JaxTrainer
from image_enhance_keras_tpu.utils.config import Config as JaxConfig
from image_enhance_keras_tpu_torch.data.io import imwrite
from image_enhance_keras_tpu_torch.engine import SuperResolver
from image_enhance_keras_tpu_torch.models.weights import flatten_params
from image_enhance_keras_tpu_torch.train import checkpoints as port_ckpt
from image_enhance_keras_tpu_torch.train import trainer as port_trainer
from image_enhance_keras_tpu_torch.train.trainer import Trainer as PortTrainer
from image_enhance_keras_tpu_torch.utils.config import Config as PortConfig

NARROW = dict(features=8, n_body53=1, n_light=1, n_tail53=1)
HISTORY_RTOL, PARAM_ATOL = 1e-4, 1e-6
FORWARD_ATOL, FP16_ATOL = 3e-5, 5e-4
#: the zoo at narrow width, for the CLI
ZOO_NARROW = {
    "didbl": NARROW,
    "didbl_subpixel": NARROW,
    "difv4": dict(features=8, n_head=1, n_mid=1, n_tail=1),
    "difv4_x2": dict(features=8, n_head=1, n_mid=1, n_tail=1),
    "difvdsr": dict(features=8, n_blocks=1),
}


def _images(n, side, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side]
    out = []
    for _ in range(n):
        base = np.stack([yy * rng.uniform(1, 4), xx * rng.uniform(1, 4), (yy + xx) * 2], -1)
        out.append(np.clip(base + rng.integers(0, 48, (side, side, 3)), 0, 255).astype(np.uint8))
    return out


def _cfg(cls, ckpt, **kw):
    base = dict(model="didbl", model_kwargs=NARROW, batch_size=2, lr=1e-3, lr_patch=6, steps_per_epoch=2,
                epochs=2, checkpoint_dir=str(ckpt), monitor="val_ssim_y", ema_decay=0.5)
    base.update(kw)
    return cls(**base)


def _pair(tmp_path, **kw):
    train, val = _images(3, 40, 0), _images(2, 48, 1)
    jt = JaxTrainer(_cfg(JaxConfig, tmp_path / "jax", **kw), train, val)
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    pt = PortTrainer(_cfg(PortConfig, tmp_path / "port", **kw), train, val, params=params, device="cpu")
    return jt, pt, params


def test_fit_matches_jax(tmp_path):
    jt, pt, _ = _pair(tmp_path, clip_norm=0.5, lr_schedule="cosine")
    want, got = jt.fit(), pt.fit()
    assert set(got) == set(want)
    for k in want:
        if k != "sec":
            np.testing.assert_allclose(got[k], want[k], rtol=HISTORY_RTOL, err_msg=k)
    ji = json.loads((tmp_path / "jax" / "index.json").read_text())
    pi = json.loads((tmp_path / "port" / "index.json").read_text())
    assert set(pi) == set(ji) and pi["best_epoch"] == ji["best_epoch"]
    assert [e["epoch"] for e in pi["epochs"]] == [e["epoch"] for e in ji["epochs"]] == [1, 2]
    for name in ("history.json", "latest_ema.npz", "best_ema.npz", "latest", "best"):
        assert (tmp_path / "jax" / name).exists() and (tmp_path / "port" / name).exists(), name
    assert (tmp_path / "port" / "latest" / port_ckpt.STATE_FILE).is_file()
    # the params and the exported EMA shadow (the weights the gate scored)
    je = flatten_params(jax_ckpt.load_params_npz(str(tmp_path / "jax" / "latest_ema.npz")))
    pe = flatten_params(port_ckpt.load_params_npz(str(tmp_path / "port" / "latest_ema.npz")))
    jp = flatten_params(jax.tree_util.tree_map(np.asarray, jt.state.params))
    for k, v in je.items():
        np.testing.assert_allclose(pe[k], v, rtol=0, atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose(pt.state.params()[k].numpy(), jp[k], rtol=0, atol=PARAM_ATOL, err_msg=k)


def test_resume_continues_numbering_and_state(tmp_path):
    train, val = _images(2, 40, 2), _images(1, 48, 3)
    cfg = _cfg(PortConfig, tmp_path / "ck", monitor="val_psnr", epochs=2)
    t = PortTrainer(cfg, train, val, device="cpu")
    t.fit()
    assert [e["epoch"] for e in t.ckpt.index["epochs"]] == [1, 2] and t.state.step == 4

    t2 = PortTrainer(cfg, train, val, device="cpu")
    assert t2.resume()
    assert t2.state.step == 4 and t2.state.opt.count == 4
    for k, v in t.state.params().items():
        np.testing.assert_array_equal(t2.state.params()[k].numpy(), v.numpy())
        np.testing.assert_array_equal(t2.state.ema[k].numpy(), t.state.ema[k].numpy())
    for k, v in t.state.opt.mu.items():
        np.testing.assert_array_equal(t2.state.opt.mu[k].numpy(), v.numpy())
        np.testing.assert_array_equal(t2.state.opt.nu[k].numpy(), t.state.opt.nu[k].numpy())
    t2.fit()  # the budget is already trained: a no-op
    assert [e["epoch"] for e in t2.ckpt.index["epochs"]] == [1, 2]

    t3 = PortTrainer(cfg, train, val, device="cpu")
    assert t3.resume()
    hist = t3.fit(epochs=3)  # one more epoch, labelled 3
    assert [e["epoch"] for e in t3.ckpt.index["epochs"]] == [1, 2, 3] and hist["epoch"] == [1, 2, 3]
    assert t3.state.step == 6 and t3.state.opt.count == 6
    assert not PortTrainer(cfg, train, val, device="cpu").ckpt.restore_latest() is None


def test_checkpoint_manager_semantics(tmp_path):
    m = port_ckpt.CheckpointManager(str(tmp_path / "ck"), monitor="val_loss", mode="min")
    state = {"params": {"w": torch.zeros(2)}, "step": 1}
    assert m.save_epoch(state, 1, {"val_loss": 0.5})
    assert not m.save_epoch(state, 2, {"val_loss": 0.9})
    assert m.save_epoch(state, 3, {"val_loss": 0.1})
    assert m.index["best_epoch"] == 3
    n = port_ckpt.CheckpointManager(str(tmp_path / "nan"), monitor="val_psnr")
    assert not n.save_epoch(state, 1, {"val_psnr": float("nan")}) and n.index["best_metric"] is None
    assert n.save_epoch(state, 2, {"val_psnr": 30.0})
    assert port_ckpt.CheckpointManager(str(tmp_path / "ck")).index["best_epoch"] == 3  # reloads the index
    assert torch.equal(m.restore_best()["params"]["w"], torch.zeros(2))


@pytest.mark.parametrize("dtype,atol", [(None, FORWARD_ATOL), (np.float16, FP16_ATOL)])
def test_port_npz_export_serves_in_jax(tmp_path, dtype, atol):
    cfg = _cfg(PortConfig, tmp_path / "ck", monitor="val_psnr", epochs=1, steps_per_epoch=1)
    t = PortTrainer(cfg, _images(2, 40, 4), device="cpu")
    t.fit()
    path = str(tmp_path / "w.npz")
    port_ckpt.export_params_npz(path, t.state.params(), dtype=dtype)
    module = FlaxDidbl(**NARROW)
    like = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
    params = jax_ckpt.load_params_npz(path, like)
    if dtype is not None:
        assert np.load(path)["level1/kernel"].dtype == np.float16
    x = np.random.default_rng(5).random((1, 12, 10, 3), dtype=np.float32)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = t.module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_engine_loads_port_trainstate_checkpoint(tmp_path):
    cfg = _cfg(PortConfig, tmp_path / "ck", monitor="val_psnr", epochs=1, steps_per_epoch=1)
    t = PortTrainer(cfg, _images(2, 40, 6), device="cpu")
    t.fit()
    for which in ("latest", "best"):
        r = SuperResolver(model="didbl", model_kwargs=NARROW, weights=os.path.join(cfg.checkpoint_dir, which),
                          device="cpu")
        for k, v in t.state.params().items():
            np.testing.assert_array_equal(flatten_params(r.params)[k].numpy(), v.numpy())
    # a directory without the port's state file (an orbax checkpoint) is refused
    os.makedirs(tmp_path / "orbax" / "latest")
    (tmp_path / "orbax" / "latest" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="an orbax checkpoint directory takes JAX"):
        SuperResolver(model="didbl", model_kwargs=NARROW, weights=str(tmp_path / "orbax" / "latest"), device="cpu")


def test_engine_model_kwargs_and_trainer_mesh():
    r = SuperResolver(model="difv4", model_kwargs=dict(features=8, n_head=1, n_mid=1, n_tail=1), device="cpu")
    assert r.module.features == 8
    # a mesh= that is not a mesh is refused (data-parallel training is ported)
    with pytest.raises(TypeError, match="mesh must be a parallel.mesh.Mesh"):
        PortTrainer(PortConfig(model_kwargs=NARROW), mesh=object(), device="cpu")


@pytest.mark.parametrize("model", sorted(ZOO_NARROW))
def test_learn_cli_trains_the_zoo_on_cpu(tmp_path, monkeypatch, model):
    from image_enhance_keras_tpu_torch.cli.learn import main

    orig = port_trainer.get_model
    monkeypatch.setattr(port_trainer, "get_model",
                        lambda name, dtype=None, **kw: orig(name, dtype=dtype, **{**ZOO_NARROW[name], **kw}))
    for sub, (n, side, seed) in (("train", (2, 40, 7)), ("val", (1, 48, 8))):
        os.makedirs(tmp_path / sub)
        for i, img in enumerate(_images(n, side, seed)):
            imwrite(str(tmp_path / sub / f"{i}.png"), img)
    ck = tmp_path / "ck"
    argv = ["--model", model, "--train-dir", str(tmp_path / "train"), "--val-dir", str(tmp_path / "val"),
            "--epochs", "1", "--steps-per-epoch", "2", "--batch-size", "2", "--lr-patch", "6",
            "--checkpoint-dir", str(ck), "--device", "cpu", "--augment"]
    assert main(argv) == 0
    hist = json.loads((ck / "history.json").read_text())
    assert hist["epoch"] == [1] and np.isfinite(hist["loss"][0]) and np.isfinite(hist["val_ssim_y"][0])
    assert main([*argv, "--resume", "--epochs", "2"]) == 0
    assert json.loads((ck / "history.json").read_text())["epoch"] == [1, 2]
    assert port_ckpt.restore_params(str(ck / "latest"))["step"] == 4


def test_learn_cli_rejects_devices_and_defaults_to_cuda(tmp_path, monkeypatch):
    """``--devices 2`` (refused before the scale-out slice) trains over a
    2-entry mesh, as JAX's CLI does over 2 of its virtual devices; both write
    one epoch of history.  Without CUDA the default device raises."""
    from image_enhance_keras_tpu.cli.learn import main as jax_main
    from image_enhance_keras_tpu.train import trainer as jax_trainer
    from image_enhance_keras_tpu_torch.cli.learn import main

    meshes = []
    orig_init = PortTrainer.__init__
    monkeypatch.setattr(PortTrainer, "__init__",
                        lambda self, *a, **kw: meshes.append(kw.get("mesh")) or orig_init(self, *a, **kw))
    for mod in (port_trainer, jax_trainer):
        orig = mod.get_model
        monkeypatch.setattr(mod, "get_model", lambda name, dtype=None, _o=orig, **kw: _o(name, dtype=dtype,
                                                                                          **{**NARROW, **kw}))
    argv = ["--devices", "2", "--epochs", "1", "--steps-per-epoch", "1", "--batch-size", "2", "--lr-patch", "6"]
    assert main([*argv, "--device", "cpu", "--checkpoint-dir", str(tmp_path / "port")]) == 0
    assert jax_main([*argv, "--checkpoint-dir", str(tmp_path / "jax")]) == 0
    assert len(meshes) == 1 and meshes[0].local_devices() == [torch.device("cpu")] * 2
    for d in ("port", "jax"):
        assert json.loads((tmp_path / d / "history.json").read_text())["epoch"] == [1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--checkpoint-dir", str(tmp_path), "--epochs", "1"])
