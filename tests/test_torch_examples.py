"""
The PyTorch port's examples (examples/torch/*.py): each one parses, takes
--device with the card as its default, and imports nothing of jax or the
JAX package; the quickstart runs on the CPU to the reference energy.
"""

import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch")
NAMES = ["00_quickstart", "01_hubbard_1d_dmet",
         "02_sc_dmet_attractive_hubbard", "03_abinitio_h_ring",
         "04_dft_in_dmet", "05_threeband_cuprate", "06_diamond_dmet",
         "07_nio_afm_dmet", "08_nio_fm_dmet", "09_cuo2_afm_dmet"]


def test_every_jax_example_has_a_port():
    jax_names = sorted(f[:-3] for f in os.listdir(os.path.join(REPO,
                                                               "examples"))
                       if f.endswith(".py"))
    assert sorted(f[:-3] for f in os.listdir(EXAMPLES)
                  if f.endswith(".py")) == jax_names == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_only_the_port(name):
    tree = ast.parse(open(os.path.join(EXAMPLES, name + ".py")).read())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    tops = {m.split(".")[0] for m in mods}
    assert "jax" not in tops and "libdmet_preview_tpu" not in tops, tops
    assert "libdmet_preview_tpu_torch" in tops
    # --device, the card by default
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", "") == "add_argument"]
    dev = [c for c in calls if c.args and getattr(c.args[0], "value", None)
           == "--device"]
    assert len(dev) == 1
    default = [k.value.value for k in dev[0].keywords if k.arg == "default"]
    assert default == ["cuda"]


def test_quickstart_reaches_the_reference_on_the_cpu():
    """The loop stops at |dE| < 1e-5 (DmetConfig.conv_tol_E), so the
    energy per site is held to the reference -0.552733945 at 1e-5."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "00_quickstart.py"),
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    E = float(re.search(r"energy per site\s*:\s*(-?\d+\.\d+)", out).group(1))
    assert abs(E - (-0.552733945)) < 1e-5
    assert "converged        : True" in out
    nelec = float(re.search(r"impurity filling\s*:\s*(\d+\.\d+)",
                            out).group(1))
    assert abs(nelec - 1.0) < 1e-5
