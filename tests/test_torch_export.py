"""The port's serving export against the live pipeline and the JAX package's.

`pipeline/export.py` traces the serving graph with `torch.export`, keeping
the hand-written kernels as the custom ops of `ops/kernels/library.py`;
here everything runs on the CPU, where each op takes its plain version.
Weights: the seeded models of tests/test_torch_pipeline.py (`models`: the
JAX converter's variables, the UNet head centred on the fixture's grays),
at img_size 32. Grades compare exactly: the inputs' seg logits lie more
than 1e-3 from the mask threshold and their classifier logits' top two
more than 1e-3 apart (asserted), so both packages' float32 rounding
cannot move a grade. The JAX side is its own artifact
(`unet_goolenet_tpu.pipeline.export`) and `infer_from_rgb`, built with the
Pallas levels off, as tests/test_export.py builds them.

Each export takes seconds (a trace of the whole pipeline, then ~140 MB of
float32 weights written) and each load seconds more, so three artifacts
serve every check: a gray one with a symbolic batch, exported by the CLI,
an all-fused rgb one at a static batch, and a bf16 rgb round trip. bf16
artifacts are also held to the live pipeline on the card (chip_smoke.py,
phase 5d); the ops' bf16 shapes and dtypes are held by opcheck.
"""

import json
import os
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import S, models  # noqa: F401  (module fixture)
from test_torch_serving import _post_npy
from unet_goolenet_tpu.models import GoogLeNetClassifier as JGNet
from unet_goolenet_tpu.models import UNetTaskAligWeight as JUNet
from unet_goolenet_tpu.pipeline import TwoStagePipeline as JPipeline
from unet_goolenet_tpu.pipeline import export as jexport
from unet_goolenet_tpu_torch import __main__ as dispatcher
from unet_goolenet_tpu_torch.apps import export_serving as export_app
from unet_goolenet_tpu_torch.apps import serve
from unet_goolenet_tpu_torch.ops.kernels import down1, up1, up2
from unet_goolenet_tpu_torch.ops.kernels.down1 import down1_weights
from unet_goolenet_tpu_torch.pipeline import (
    TwoStagePipeline, export_serving, load_serving, preprocess_gray)
from unet_goolenet_tpu_torch.pipeline.export import META, ServingArtifact
from unet_goolenet_tpu_torch.train.checkpoint import CheckpointManager
from unet_goolenet_tpu_torch.train.optim import make_adamw
from unet_goolenet_tpu_torch.train.seg import SegState
from torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW = (40, 48)
MARGIN = 1e-3
FUSED = dict(fused_up2=True, fused_up34=True, fused_down1=True)
OPS = ("up1_gate", "up1_tail", "up_gate_dense", "up_level", "pool_down1")   # ugt::*


def grays(n, seed):
    return np.random.default_rng(seed).uniform(0.0, 255.0, (n, *RAW)).astype(np.float32)


def well_conditioned(out):
    """Assert that no seg logit lies within MARGIN of the threshold and that
    each image's top two classifier logits are MARGIN apart."""
    top2 = out["cls_logits"].float().topk(2, dim=-1).values
    assert out["seg_logits"].float().abs().min() > MARGIN
    assert (top2[:, 0] - top2[:, 1]).min() > MARGIN


def graph_ops(artifact):
    """The ugt:: op calls in a loaded artifact's graph, by name and count."""
    ops = {}
    for node in artifact._module.graph.nodes:
        name = str(node.target)
        if name.startswith("ugt."):
            ops[name] = ops.get(name, 0) + 1
    return ops


def jax_pipeline(uv, gv):
    """The JAX pipeline with its Pallas levels off (its exportable graph)."""
    return JPipeline(JUNet(n_classes=1), jax.tree_util.tree_map(jnp.asarray, uv),
                     JGNet(num_classes=6), jax.tree_util.tree_map(jnp.asarray, gv),
                     img_size=S, fused_up1=False, dense_fused_up1=False, dense_batch_min=1)


# ------------------------------------------------------------------ the ops


def _gate_case():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 6, 64, generator=g)
    w, b = torch.randn(64, 64, 3, 3, generator=g) * 0.04, torch.randn(64, generator=g) * 0.1
    return x, up2.up_gate_weights(w, b, torch.float32)


def _level_args(c, cq, ncls=0):
    g = torch.Generator().manual_seed(2)
    r = lambda *s: torch.randn(*s, generator=g) * 0.1
    x, e1, gate1p = r(2, 3, 4, c), r(2, 6, 8, c).abs(), 1.0 + r(2, c).abs()
    level = (r(c, c, 2, 2), r(c), r(c, c, 3, 3), r(c), r(cq, 2 * c, 3, 3), r(cq),
             r(cq, cq, 3, 3), r(cq))
    if ncls:
        return x, e1, gate1p, up1.tail_weights(*level, r(ncls, cq, 1, 1), r(ncls),
                                               dtype=torch.float32)
    return x, e1, gate1p, up2.up_level_weights(*level, dtype=torch.float32)


def op_case(name, dtype):
    """(op, its arguments, the plain version) on small CPU tensors whose
    activations are of `dtype` (the weights as the plain versions take
    them)."""
    if name in ("up1_gate", "up_gate_dense"):
        x, wts = _gate_case()
        ref = up1.up1_gate_ref if name == "up1_gate" else up2.up_gate_dense_ref
        return getattr(torch.ops.ugt, name).default, (x.to(dtype), wts.args(x)), ref
    if name == "pool_down1":
        g = torch.Generator().manual_seed(3)
        r = lambda *s: torch.randn(*s, generator=g) * 0.05
        x1 = torch.randn(1, 8, 12, 64, generator=g)
        wts = down1_weights(r(128, 64, 3, 3), r(128), r(128, 128, 3, 3), r(128), torch.float32)
        return getattr(torch.ops.ugt, name).default, (x1.to(dtype), wts.args(x1)), down1.pool_down1_ref
    if name == "up1_tail":
        x, e1, gate1p, wts = _level_args(64, 64, 3)
        ref = up1.up1_tail_ref
    else:
        x, e1, gate1p, wts = _level_args(128, 64)
        ref = up2.up_level_ref
    return getattr(torch.ops.ugt, name).default, (x.to(dtype), e1.to(dtype), gate1p, wts.args(x)), ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", OPS)
def test_op_passes_opcheck(name, dtype):
    """Each custom op's schema, fake implementation (shapes and dtypes from
    the inputs, a symbolic batch among them: the gates' statistics float32
    whatever the input dtype) and dispatch, by torch.library.opcheck; on
    the CPU its result is the plain version's, bit for bit."""
    op, args, ref = op_case(name, dtype)
    torch.library.opcheck(op, args)
    got, want = op(*args), ref(*args[:-1], *args[-1])
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ------------------------------------------------------------ gray artifact


@pytest.fixture(scope="module")
def gray_artifact(tmp_path_factory, models):
    """apps.export_serving on checkpoints as the CLI tests write them (the
    UNet as the port trainer's snapshot, the classifier as {'net': ...}):
    the default float32 pipeline from gray with a symbolic batch (traced at
    N = 2), reloaded and checked by --check; `serve --artifact` over it; and
    the live pipeline. The server is handed the artifact --check loaded from
    the same directory (a load takes seconds; the fresh-interpreter test
    loads one of its own)."""
    unet, gnet = models[-2:]
    d = tmp_path_factory.mktemp("gray")
    snapshot = CheckpointManager(str(d / "ckpt")).save_best_loss(
        SegState(unet, make_adamw(unet.parameters())), 3)
    torch.save({"net": gnet.state_dict()}, d / "gnet.pt")
    out = str(d / "art")
    loaded = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(export_app, "load_serving",
                   lambda *a: loaded.append(load_serving(*a)) or loaded[-1])
        meta = export_app.main(["--unet-checkpoint", snapshot, "--gnet-checkpoint",
                                str(d / "gnet.pt"), "--out-dir", out, "--raw-hw", *map(str, RAW),
                                "--img-size", str(S), "--device", "cpu", "--check"])
        mp.setattr(serve, "load_serving", lambda path, device: loaded[0] if (
            path, device) == (out, "cpu") else pytest.fail(f"serve loaded {path} on {device}"))
        srv = serve.build_server(serve.parse_args(["--artifact", out, "--device", "cpu",
                                                   "--max-batch", "4"]))
    yield out, meta, TwoStagePipeline(unet, gnet, img_size=S, device="cpu"), srv
    srv.close()


def test_gray_artifact_matches_live_and_jax_artifact(tmp_path, models, gray_artifact):
    """At batch sizes not seen at export (1, 3, 5), the artifact's grades
    are the live pipeline's and the JAX package's own artifact's from the
    same weights; its graph calls up1's two kernels as ops (traced
    through, it would hold their plain ops instead)."""
    _, uv, gv = models[:3]
    out, meta, pipe, srv = gray_artifact
    artifact = srv.batcher._grade_fn.pipe
    assert isinstance(artifact, ServingArtifact)
    assert meta == {"source": "gray", "raw_hw": list(RAW), "img_size": S,
                    "dtype": "float32", "device": "cpu", "torch_version": torch.__version__,
                    "fused_levels": ["up1"], "static_batch": None}
    assert graph_ops(artifact) == {"ugt.up1_gate.default": 1, "ugt.up1_tail.default": 1}
    jexport.export_serving(jax_pipeline(uv, gv), str(tmp_path), raw_hw=RAW,
                           platforms=("cpu",))
    jrunner = jexport.load_serving(str(tmp_path))
    for n, seed in ((1, 4), (3, 5), (5, 6)):
        batch = grays(n, seed)
        live = pipe.infer_from_gray(batch)
        well_conditioned(live)
        got = artifact(batch)
        assert got.shape == (n,) and got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), live["grades"].numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(jrunner(batch)))


def test_serve_artifact_http_parity(gray_artifact):
    """serve --artifact: warmed on every bucket, the server answers with
    the live pipeline's grades, and its meta is the artifact's."""
    out, meta, pipe, srv = gray_artifact
    assert srv.warmup() == [1, 2, 4]
    port = srv.start()
    batch = grays(3, 5)
    assert _post_npy(port, batch)["grades"] == pipe.infer_grades(batch).tolist()
    assert _post_npy(port, batch[1])["grades"] == pipe.infer_grades(batch[1:2]).tolist()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health["meta"] == meta and health["images"] == 4


def test_cuda_artifact_without_a_card_raises(tmp_path, gray_artifact):
    """An artifact exported on a card does not move to the CPU: on a host
    without one, loading it raises; nor does an artifact run on another
    device type than its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    (tmp_path / META).write_text(json.dumps(dict(gray_artifact[1], device="cuda")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving(str(tmp_path))
    with pytest.raises(ValueError, match="exported for cpu"):
        load_serving(gray_artifact[0], "meta")


# ------------------------------------------------------------ the all-fused rgb artifact


@pytest.fixture(scope="module")
def fused_artifact(tmp_path_factory, models):
    """The all-fused float32 pipeline exported from rgb with keep_fused at
    a static batch of 2, reloaded; the live pipeline; and five rgb images:
    the gray test's batch of 5, preprocessed (the images the seg head was
    centred for, rather than noise)."""
    unet, gnet = models[-2:]
    pipe = TwoStagePipeline(unet, gnet, img_size=S, device="cpu", **FUSED)
    out = str(tmp_path_factory.mktemp("fused"))
    meta = export_serving(pipe, out, source="rgb", keep_fused=True, static_batch=2)
    imgs = preprocess_gray(torch.from_numpy(grays(5, 6)), out_hw=(S, S)).numpy()
    return out, meta, pipe, load_serving(out), imgs


def test_fused_rgb_static_artifact_matches_live_and_jax(models, fused_artifact):
    """keep_fused with all three fused-level knobs on, from rgb, at a static
    batch of 2: the graph calls all five kernels' ops (up2-up4 a gate and a
    level each); N = 5 runs as three calls of 2 (the last padded with a
    zero image, the grades sliced back to 5), with the grades of the live
    all-fused pipeline and of JAX's infer_from_rgb (Pallas levels off) on
    the 5 at once."""
    _, uv, gv = models[:3]
    _, meta, pipe, artifact, imgs = fused_artifact
    assert meta["source"] == "rgb" and meta["raw_hw"] == [S, S] and meta["static_batch"] == 2
    assert meta["fused_levels"] == ["up1", "fused_up2", "fused_up34", "fused_down1"]
    assert graph_ops(artifact) == {
        "ugt.pool_down1.default": 1, "ugt.up_gate_dense.default": 3,
        "ugt.up_level.default": 3, "ugt.up1_gate.default": 1, "ugt.up1_tail.default": 1}
    live = pipe.infer_from_rgb(imgs)
    well_conditioned(live)
    got = artifact(imgs).numpy()
    np.testing.assert_array_equal(got, live["grades"].numpy())
    want = jax_pipeline(uv, gv).infer_from_rgb(jnp.asarray(imgs))["grades"]
    np.testing.assert_array_equal(got, np.asarray(want))


def test_load_serving_imports_no_model_code(tmp_path, fused_artifact):
    """A fresh interpreter that imports only pipeline.export loads the
    all-fused artifact and grades; neither the port's model code nor JAX is
    loaded."""
    out, _, pipe, _, imgs = fused_artifact
    np.save(tmp_path / "batch.npy", imgs[:3])
    code = ("import json, sys\n"
            "import numpy as np, torch\n"
            "torch.set_num_threads(2)\n"
            "from unet_goolenet_tpu_torch.pipeline.export import load_serving\n"
            "grades = load_serving(sys.argv[1])(np.load(sys.argv[2])).tolist()\n"
            "print(json.dumps({'grades': grades, 'loaded': [m for m in sys.argv[3:] "
            "if m in sys.modules]}))\n")
    absent = ["unet_goolenet_tpu_torch.models", "unet_goolenet_tpu_torch.pipeline.engine",
              "unet_goolenet_tpu_torch.pipeline.two_stage", "unet_goolenet_tpu", "jax"]
    run = subprocess.run([sys.executable, "-c", code, out, str(tmp_path / "batch.npy"), *absent],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    assert got["grades"] == pipe.infer_from_rgb(imgs[:3])["grades"].tolist()


def test_bf16_round_trip(tmp_path, models):
    """The default pipeline in bf16, exported from rgb with a symbolic batch
    and reloaded: meta says bfloat16, the graph calls up1's two ops, and at
    N = 3 (not the traced 2) the grades are the live bf16 pipeline's."""
    unet, gnet = models[-2:]
    pipe = TwoStagePipeline(unet, gnet, img_size=S, device="cpu", dtype=torch.bfloat16)
    meta = export_serving(pipe, str(tmp_path), source="rgb")
    assert meta["dtype"] == "bfloat16" and meta["static_batch"] is None
    artifact = load_serving(str(tmp_path))
    assert graph_ops(artifact) == {"ugt.up1_gate.default": 1, "ugt.up1_tail.default": 1}
    imgs = preprocess_gray(torch.from_numpy(grays(3, 5)), out_hw=(S, S)).numpy()
    got = artifact(imgs)
    assert got.shape == (3,) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), pipe.infer_from_rgb(imgs)["grades"].numpy())


@pytest.mark.parametrize("refusal", ["knobs_without_keep_fused", "gray_without_raw_hw"])
def test_export_refusals(tmp_path, models, refusal):
    unet, gnet = models[-2:]
    if refusal == "knobs_without_keep_fused":
        pipe = TwoStagePipeline(unet, gnet, img_size=S, device="cpu", fused_up2=True)
        with pytest.raises(ValueError, match="fused_up2.*keep_fused=True"):
            export_serving(pipe, str(tmp_path), raw_hw=RAW)
    else:
        pipe = TwoStagePipeline(unet, gnet, img_size=S, device="cpu")
        with pytest.raises(ValueError, match="raw_hw"):
            export_serving(pipe, str(tmp_path))
    assert not (tmp_path / META).exists()


# ------------------------------------------------------------ the dispatcher


def test_dispatcher_usage_and_exit_codes(capsys):
    """`python -m unet_goolenet_tpu_torch <command>`: --help exits 0 and
    names the six commands, no command or an unknown one exits 2, and a
    command reaches its app's argparse."""
    with pytest.raises(SystemExit) as e:
        dispatcher.main([])
    assert e.value.code == 2 and "usage:" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        dispatcher.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for cmd in ("train-seg", "predict-seg", "train-cls", "infer-e2e", "serve", "export"):
        assert cmd in out
    with pytest.raises(SystemExit) as e:
        dispatcher.main(["not-a-command"])
    assert e.value.code == 2 and "unknown command" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        dispatcher.main(["export", "--help"])
    assert e.value.code == 0 and "--keep-fused" in capsys.readouterr().out
