"""The PyTorch port and chip_smoke.py import neither jax nor the JAX package.

A subprocess imports every module of the port and chip_smoke.py (this test
process has jax loaded already, from tests/conftest.py), then lists what got
loaded. An AST scan of the sources backs it up. Names match exactly or with
a dot after them: ``speech_cloner_tpu`` is a prefix of ``speech_cloner_tpu_torch``.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "speech_cloner_tpu_torch"


def forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "speech_cloner_tpu" or top.startswith("jax")


def port_modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_forbidden_matches_exact_names():
    assert forbidden("jax") and forbidden("jax.numpy") and forbidden("jaxlib.xla_client")
    assert forbidden("speech_cloner_tpu") and forbidden("speech_cloner_tpu.ops.mel")
    assert not forbidden("speech_cloner_tpu_torch") and not forbidden("speech_cloner_tpu_torch.ops")
    assert not forbidden("torch")


@pytest.mark.parametrize("module", ["speech_cloner_tpu_torch.runtime.tf_bundle",
                                    "speech_cloner_tpu_torch.runtime.tf_import",
                                    "speech_cloner_tpu_torch.apps.serve",
                                    "speech_cloner_tpu_torch.runtime.tree",
                                    "speech_cloner_tpu_torch.runtime.logging",
                                    "speech_cloner_tpu_torch.train",
                                    "speech_cloner_tpu_torch.train.metrics",
                                    "speech_cloner_tpu_torch.train.optimizer",
                                    "speech_cloner_tpu_torch.train.steps",
                                    "speech_cloner_tpu_torch.train.bn_recal",
                                    "speech_cloner_tpu_torch.train.loop",
                                    "speech_cloner_tpu_torch.train.evaluate",
                                    "speech_cloner_tpu_torch.data.dataset",
                                    "speech_cloner_tpu_torch.data.timit",
                                    "speech_cloner_tpu_torch.data.arctic",
                                    "speech_cloner_tpu_torch.apps.train_encoder",
                                    "speech_cloner_tpu_torch.apps.train_decoder",
                                    "speech_cloner_tpu_torch.models.speaker_id",
                                    "speech_cloner_tpu_torch.train.augment",
                                    "speech_cloner_tpu_torch.pipeline.verify",
                                    "speech_cloner_tpu_torch.apps.train_speaker_id",
                                    "speech_cloner_tpu_torch.data.audio_io",
                                    "speech_cloner_tpu_torch.data.packed_cache",
                                    "speech_cloner_tpu_torch.data.device_dataset",
                                    "speech_cloner_tpu_torch.data.target_spk",
                                    "speech_cloner_tpu_torch.data.synth_corpus",
                                    "speech_cloner_tpu_torch.data.viz",
                                    "speech_cloner_tpu_torch.apps.clone_demo",
                                    "speech_cloner_tpu_torch.apps.train_full",
                                    "speech_cloner_tpu_torch.apps.evaluate",
                                    "speech_cloner_tpu_torch.apps.make_synth_corpus",
                                    "speech_cloner_tpu_torch.apps.convert_audio",
                                    "speech_cloner_tpu_torch.apps.clean_ckpt",
                                    "speech_cloner_tpu_torch.parallel",
                                    "speech_cloner_tpu_torch.parallel.mesh",
                                    "speech_cloner_tpu_torch.parallel.collectives",
                                    "speech_cloner_tpu_torch.parallel.sharding",
                                    "speech_cloner_tpu_torch.parallel.distributed",
                                    "speech_cloner_tpu_torch.parallel.halo",
                                    "speech_cloner_tpu_torch.parallel.gl_sp",
                                    "speech_cloner_tpu_torch.nn.attention",
                                    "speech_cloner_tpu_torch.runtime.profiler",
                                    "speech_cloner_tpu_torch.apps.make_narrator_corpus",
                                    "speech_cloner_tpu_torch.apps.real_demo",
                                    "speech_cloner_tpu_torch.models.tacotron",
                                    "speech_cloner_tpu_torch.pipeline.tts",
                                    "speech_cloner_tpu_torch.pipeline.vocoder",
                                    "speech_cloner_tpu_torch.apps.tts"])
def test_new_modules_are_scanned(module):
    """The port's own TF bundle reader and importer, its server, the
    training slice (train/, the data readers, the trainers), the speaker-ID
    slice (the CNN, the vocoded augmentation, verification, its trainer)
    and the data runtime with the train-to-demo apps (audio decoding, the
    packed cache, the device store, the target-speaker reader, the
    synthetic corpus, the pictures, clone_demo, train_full, evaluate and
    the small apps) and the parallel layer (meshes, collectives, sharding,
    the process bootstrap, the halos, sharded Griffin-Lim) and the rest
    (the attention module, the profiler, the narrator-corpus and real-voice
    demo apps) and the text-to-speech slice (Tacotron, its pipeline, the
    shared vocoder, its app) are among the modules the import and source scans below
    cover."""
    assert module in port_modules()
    path = ROOT.joinpath(*module.split(".")).with_suffix(".py")
    if not path.exists():
        path = ROOT.joinpath(*module.split("."), "__init__.py")
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [n for n in names if forbidden(n)]


def test_import_loads_no_jax():
    mods = port_modules()
    assert "speech_cloner_tpu_torch.ops.cuda_kernels" in mods and len(mods) > 20
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "speech_cloner_tpu_torch.pipeline.clone" in loaded
    assert [m for m in loaded if forbidden(m)] == []


def test_sources_import_no_jax():
    bad = []
    for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names if forbidden(n)]
    assert bad == []
