"""The port's card-side tools against the JAX package's: checksummed
ingestion of torchvision's DenseNet-121 weights (`cli/ingest_pretrained.py`
against tools/ingest_pretrained.py and tools/convert_torchvision.py) and
the series listing (`cli/make_series.py` against tools/make_series.py), on
seeded weights and a synthetic ACDC tree. Also the guard of the test
suite's one-thread rule: every port test module takes the shared
`one_thread` fixture."""
from __future__ import annotations

import ast
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from saunet_tpu_torch.cli import ingest_pretrained, make_series
from saunet_tpu_torch.data import nifti
from saunet_tpu_torch.models import SAUNet
from saunet_tpu_torch.models.densenet import (
    DenseNetEncoder,
    load_pretrained_encoder,
    torchvision_state_dict,
)
from saunet_tpu_torch.models.init import init_random_
from test_torch_train_cli import _write_acdc
from torch_port_util import one_thread  # noqa: F401  (fixture)

TESTS = pathlib.Path(__file__).parent
TOOLS = TESTS.parent / "tools"


@pytest.fixture(scope="module")
def seeded_pth(tmp_path_factory):
    """A seeded encoder and its torchvision-named `densenet121-<sha8>.pth`,
    `<sha8>` the file's own digest prefix."""
    encoder = init_random_(DenseNetEncoder(), torch.Generator().manual_seed(5))
    d = tmp_path_factory.mktemp("hub")
    tmp = d / "densenet121.pth"
    torch.save(torchvision_state_dict(encoder), tmp)
    digest = hashlib.sha256(tmp.read_bytes()).hexdigest()
    path = d / f"densenet121-{digest[:8]}.pth"
    tmp.rename(path)
    return encoder, str(path), digest


def test_checksum_accepts_the_hub_suffix(seeded_pth):
    _, path, digest = seeded_pth
    assert ingest_pretrained.verify_checksum(path, None) == digest
    assert ingest_pretrained.verify_checksum(path, digest) == digest


def test_checksum_refuses_one_changed_byte(seeded_pth, tmp_path):
    _, path, _ = seeded_pth
    bad = tmp_path / os.path.basename(path)
    data = bytearray(pathlib.Path(path).read_bytes())
    data[len(data) // 2] ^= 1
    bad.write_bytes(bytes(data))
    with pytest.raises(SystemExit, match="does not match"):
        ingest_pretrained.verify_checksum(str(bad), None)
    # SKIP bypasses the check; without a suffix or --sha256 it refuses
    assert ingest_pretrained.verify_checksum(str(bad), "SKIP") \
        == hashlib.sha256(bytes(data)).hexdigest()
    plain = tmp_path / "densenet121.pth"
    shutil.copy(path, plain)
    with pytest.raises(SystemExit, match="no torch-hub checksum suffix"):
        ingest_pretrained.verify_checksum(str(plain), None)


def test_conversion_equals_the_jax_packages(seeded_pth, tmp_path):
    """Key for key and bit for bit what tools/convert_torchvision.py
    writes from the same file (`ingest` without the graft)."""
    sys.path.insert(0, str(TOOLS))
    try:
        from convert_torchvision import convert as convert_jax
    finally:
        sys.path.remove(str(TOOLS))
    _, path, digest = seeded_pth
    info = ingest_pretrained.ingest(path, str(tmp_path / "port.npz"),
                                    smoke_graft=False)
    assert info["model"] is None and info["grafted_tensors"] == 0
    assert info["src_sha256"] == digest
    n = info["tensors"]
    n_jax = convert_jax(path, str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as ours, \
            np.load(tmp_path / "jax.npz") as ref:
        assert n == n_jax == len(ref.files)
        assert ours.files == ref.files
        for k in ref.files:
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_graft_equals_loading_the_pth(seeded_pth, tmp_path):
    """`ingest` grafts every encoder tensor, and the grafted encoder's
    eval output at 32^2 equals that of the same weights loaded from the
    .pth directly."""
    encoder, path, digest = seeded_pth
    out = str(tmp_path / "w" / "densenet121.npz")
    info = ingest_pretrained.ingest(path, out, device="cpu")
    model = info["model"]
    want = {k: v for k, v in encoder.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert info["grafted_tensors"] == len(want)
    assert info["tensors"] == len(want) + 2  # the classifier's two
    assert info["src_sha256"] == digest
    with open(out + ".sha256") as f:
        assert f.read() == f"{digest}  {os.path.basename(path)}\n"
    got = model.encoder.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    direct = load_pretrained_encoder(path, SAUNet(num_classes=4))
    x = torch.from_numpy(
        np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        taps = model.encoder.eval()(x)
        taps_direct = direct.encoder.eval()(x)
    for i, (a, b) in enumerate(zip(taps, taps_direct)):
        assert torch.equal(a, b), f"tap f{i + 1}"


def test_ingest_refuses_a_mismatched_archive(tmp_path):
    """A checkpoint missing an encoder tensor does not graft."""
    sd = torchvision_state_dict(DenseNetEncoder())
    del sd["features.norm5.running_var"]
    path = tmp_path / "densenet121.pth"
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="norm5.running_var"):
        ingest_pretrained.ingest(str(path), str(tmp_path / "w.npz"),
                                 sha256="SKIP", device="cpu")


def _write_testing_nested(root):
    """The ACDC archive's own test layout, testing/testing/patientXXX,
    with files that are not frames (Info.cfg, a README)."""
    for p, frames in ((101, (1, 14)), (102, (1, 9))):
        d = os.path.join(root, "testing", "testing", f"patient{p:03d}")
        os.makedirs(d)
        for fr in frames:
            name = f"patient{p:03d}_frame{fr:02d}.nii.gz"
            nifti.save(np.zeros((4, 4, 2), np.float32),
                       os.path.join(d, name), pixdim=(1.3, 1.3, 10))
        open(os.path.join(d, "Info.cfg"), "w").close()
    open(os.path.join(root, "testing", "testing", "README"), "w").close()


@pytest.fixture(scope="module")
def acdc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("acdc"))
    _write_acdc(root)
    nested = str(tmp_path_factory.mktemp("acdc_nested"))
    _write_testing_nested(nested)
    return {"flat": root, "nested": nested}


@pytest.mark.parametrize("split, layout", [("training", "flat"),
                                           ("testing", "flat"),
                                           ("testing", "nested")])
def test_series_equals_the_jax_tool(acdc_root, split, layout, tmp_path,
                                    monkeypatch, capsys):
    root = acdc_root[layout]
    ours, ref = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    assert make_series.main([root, "--split", split, "--out", ours]) == 0
    monkeypatch.syspath_prepend(str(TOOLS))
    import make_series as make_series_jax

    monkeypatch.setattr(sys, "argv", ["make_series.py", root, "--split",
                                      split, "--out", ref])
    make_series_jax.main()
    with open(ours) as a, open(ref) as b:
        text = a.read()
        assert text == b.read()
    want = {("training", "flat"): "1 1\n1 12\n2 1\n2 12\n3 1\n3 12\n",
            ("testing", "flat"): "101 1\n",
            ("testing", "nested"): "101 1\n101 14\n102 1\n102 9\n"}
    assert text == want[(split, layout)]


def test_clis_run_without_jax(seeded_pth, acdc_root, tmp_path):
    """Both tools, and the profiler's infer mode at 32^2, as `python -m`
    with jax, flax, optax and saunet_tpu unimportable, one intra-op
    thread: the same archive and listing as in this process, and the
    profiler's table and JSON line."""
    encoder, path, _ = seeded_pth
    out, series = str(tmp_path / "w.npz"), str(tmp_path / "series.txt")
    code = (
        "import json, runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'saunet_tpu'):\n"
        "    sys.modules[m] = None\n"
        "for name, *args in json.loads(sys.argv[1]):\n"
        "    sys.argv = [name] + args\n"
        "    try:\n"
        "        runpy.run_module(name, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert not e.code, (name, e.code)\n")
    runs = [["saunet_tpu_torch.cli.ingest_pretrained", path, "--out", out,
             "--device", "cpu"],
            ["saunet_tpu_torch.cli.make_series", acdc_root["flat"],
             "--out", series],
            ["saunet_tpu_torch.cli.profile", "--what", "infer", "--device",
             "cpu", "--hw", "32", "--batch", "2", "--steps", "1"]]
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(runs)],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"),
                          cwd=str(TESTS.parent))
    assert proc.returncode == 0, proc.stderr
    grafted = sum(not k.endswith("num_batches_tracked")
                  for k in encoder.state_dict())
    assert f"(grafted {grafted} encoder tensors)" in proc.stdout
    assert "--pretrained " + out in proc.stdout
    profile = json.loads(proc.stdout.splitlines()[-1])
    assert profile["profile"] == "infer" and profile["device"] == "cpu"
    assert "k3_route" in [r["name"] for r in profile["rows"]]
    ref = str(tmp_path / "ref.npz")
    ingest_pretrained.convert(path, ref)
    with np.load(out) as a, np.load(ref) as b:
        assert a.files == b.files
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(series) as f:
        assert f.read() == "1 1\n1 12\n2 1\n2 12\n3 1\n3 12\n"


def test_every_port_test_module_takes_the_shared_one_thread_fixture():
    """Each tests/test_torch_*.py but test_torch_port.py (the JAX
    package's) imports `one_thread` from torch_port_util and defines no
    fixture of that name itself, so torch runs one intra-op thread in
    every port module."""
    files = sorted(p for p in TESTS.glob("test_torch_*.py")
                   if p.name != "test_torch_port.py")
    assert len(files) >= 21
    missing = []
    for p in files:
        tree = ast.parse(p.read_text())
        imported = any(
            isinstance(n, ast.ImportFrom) and n.module == "torch_port_util"
            and any(a.name == "one_thread" and a.asname is None
                    for a in n.names)
            for n in tree.body)
        own = any(getattr(n, "name", None) == "one_thread"
                  or (isinstance(n, ast.Assign) and any(
                      getattr(t, "id", None) == "one_thread"
                      for t in n.targets))
                  for n in tree.body)
        if not imported or own:
            missing.append(p.name)
    assert not missing, missing
