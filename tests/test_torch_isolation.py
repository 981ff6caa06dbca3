"""The port stands alone: it imports neither JAX nor the JAX package, and it
runs on the card unless the caller asks for the CPU."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import optim
from repro_torch.configs.resnet_cifar import RESNET_MICRO
from repro_torch.data.pipeline import ClientDataset, make_eval_batch
from repro_torch.data.synthetic import ClassImageTask
from repro_torch.fed.adapter import ResNetAdapter
from repro_torch.fed.client import HeteroEnv, SimClient
from repro_torch.fed.dtfl import DTFLTrainer
from repro_torch.launch import train

PKG = Path(repro_torch.__file__).parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "repro_torch."))


def test_imports_with_jax_and_repro_blocked():
    """Every module of the port imports in a process where importing
    ``jax`` or ``repro`` fails."""
    mods = ["repro_torch", "repro_torch.fed.dtfl", "repro_torch.launch.train"] + _modules()
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    src = str(PKG.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert bad == []


def _tiny_trainer_args():
    task = ClassImageTask(n_classes=10, image_size=RESNET_MICRO.image_size)
    labels = np.random.default_rng(0).integers(0, 10, 40)
    clients = [SimClient(i, ClientDataset(task, labels, np.arange(20 * i, 20 * i + 20), 8), None)
               for i in range(2)]
    return ResNetAdapter(RESNET_MICRO), clients, HeteroEnv(2), optim.adam()


def test_default_device_is_the_card(monkeypatch):
    """No device given and no CUDA device: the trainer and the CLI raise;
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DTFLTrainer(*_tiny_trainer_args())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "resnet-micro", "--clients", "2", "--rounds", "1",
                    "--samples", "40"])
    assert train.build_parser().parse_args([]).device == "cuda"
    assert DTFLTrainer(*_tiny_trainer_args(), device="cpu").device.type == "cpu"


def test_unported_options_fail_loudly(capsys, tmp_path):
    # ported options build
    ad = ResNetAdapter(RESNET_MICRO, dcor_alpha=0.5, patch_shuffle=True)
    assert (ad.dcor_alpha, ad.patch_shuffle) == (0.5, True)
    assert DTFLTrainer(*_tiny_trainer_args(), device="cpu", scheduler="pairing").topology == "pairing"
    argv = ["--arch", "resnet-micro", "--clients", "2", "--samples", "40", "--rounds", "1",
            "--device", "cpu"]
    assert len(train.main(argv + ["--codec", "topk0.05"])) == 1
    assert len(train.main(argv + ["--engine", "events", "--churn"])) == 1
    # checkpoints, resume and the async engine run on a tiny CPU case
    ckpt = str(tmp_path / "state.npz")
    assert len(train.main(argv + ["--out-ckpt", ckpt, "--save-every", "1"])) == 1
    assert [log.round for log in train.main(
        argv[:-4] + ["--rounds", "2", "--device", "cpu", "--resume", ckpt])] == [1]
    assert len(train.main(argv + ["--engine", "async", "--n-groups", "2"])) == 3
    eval_batch = make_eval_batch(ClassImageTask(10, image_size=RESNET_MICRO.image_size), 8)
    assert len(DTFLTrainer(*_tiny_trainer_args(), device="cpu").run(
        1, eval_batch, engine="async", n_groups=2)) == 3
    capsys.readouterr()
    # options still to port: names fail at parse time, the mesh when built
    for extra in (["--arch", "hymba-1.5b"], ["--arch", "yi-6b"], ["--exec", "sharded"]):
        with pytest.raises(SystemExit):
            train.build_parser().parse_args(extra)
        assert "not yet ported" in capsys.readouterr().err, extra
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train.main(argv + ["--devices", "4"])


def test_transformer_cli_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    """The SmolLM-360M path: the CLI raises without a card, trains at the
    reduced size on the CPU when asked, and the options this slice does not
    port raise "not yet ported"."""
    from repro_torch.configs import get_config
    from repro_torch.fed.adapter import TransformerAdapter

    argv = ["--arch", "smollm-360m", "--clients", "2", "--rounds", "1", "--batch-size", "2",
            "--seq-len", "16"]
    logs = train.main(argv + ["--device", "cpu"])
    assert len(logs) == 1 and np.isfinite(logs[0].acc)
    assert "[train] dtfl smollm-360m: 1 rounds" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TransformerAdapter(get_config("smollm-360m").reduced(), seq_len=16, dcor_alpha=0.5)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_config("hymba-1.5b")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TransformerAdapter(get_config("smollm-360m").reduced().replace(family="moe"),
                           seq_len=16).init_global(torch.Generator())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
