"""The port's public namespace against the JAX package's, and the few
functions that completed it, against JAX on the CPU (float64).

Every name that ``projected_lmc_tpu``'s ``__init__`` files bind (read from
their import statements and assignments with ``ast``, for the package and
its ``ops``, ``models``, ``parallel``, ``utils`` and ``experiments``)
resolves on the port's counterpart, or is on the port's
``ABSENT_BY_DESIGN`` list; each entry of that list exists in JAX, is absent
from the port and is named in the port's docstring. ``import
projected_lmc_tpu_torch`` loads no JAX, pandas or matplotlib and builds no
kernel. ``examples_torch/`` holds JAX's four examples, each importing
neither JAX nor ``projected_lmc_tpu`` and taking ``--cpu``.

Parity: ``ops.symmetrize`` exactly; ``ScaleKernel.set_lengthscale`` then a
forward at rtol 1e-6, and the same exception on a kernel without a
lengthscale; ``with_task_covar_factor`` then ``task_covariance`` at rtol
1e-6.
"""

import ast
import importlib
import inspect
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import projected_lmc_tpu as jpl
import projected_lmc_tpu_torch as pl
from projected_lmc_tpu import kernels as jker
from projected_lmc_tpu import likelihoods as jlik
from projected_lmc_tpu.ops import cholesky as jchol
from projected_lmc_tpu_torch import kernels as tker
from projected_lmc_tpu_torch import likelihoods as tlik
from projected_lmc_tpu_torch.models import projected as tprojected
from projected_lmc_tpu_torch.ops import cholesky as tchol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("", "ops", "models", "parallel", "utils", "experiments")
BY_DESIGN = dict(pl.ABSENT_BY_DESIGN)


def bound_names(path):
    """Names a module's top level binds by import or assignment."""
    names = []
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Import):
            names += [a.asname or a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return names


def resolve(root: str, dotted: str):
    """``root.dotted`` by attributes, importing submodules on the way;
    raises AttributeError where a part is missing."""
    obj = importlib.import_module(root)
    for part in dotted.split("."):
        if not hasattr(obj, part) and inspect.ismodule(obj):
            try:
                importlib.import_module(f"{obj.__name__}.{part}")
            except ModuleNotFoundError:
                pass
        obj = getattr(obj, part)
    return obj


def params_of(obj):
    """Parameter names of a function, or of every ``__init__`` of a class's
    MRO."""
    fns = [c.__init__ for c in obj.__mro__ if "__init__" in vars(c)] \
        if inspect.isclass(obj) else [obj]
    return {p for f in fns for p in inspect.signature(f).parameters}


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_every_jax_name_resolves(sub):
    init = os.path.join(REPO, "projected_lmc_tpu", *sub.split("."),
                        "__init__.py") if sub else \
        os.path.join(REPO, "projected_lmc_tpu", "__init__.py")
    names = bound_names(init)
    assert len(names) >= 5, names
    port = importlib.import_module(
        "projected_lmc_tpu_torch" + (f".{sub}" if sub else ""))
    missing = [n for n in names if not hasattr(port, n)
               and (f"{sub}.{n}" if sub else n) not in BY_DESIGN]
    assert not missing, f"{sub or 'top level'}: {missing}"
    assert all(n in dir(port) for n in getattr(port, "__all__", []))


def test_absent_by_design_list():
    assert isinstance(pl.ABSENT_BY_DESIGN, tuple)
    doc = " ".join(pl.__doc__.split())
    for entry, reason in pl.ABSENT_BY_DESIGN:
        assert f"``{entry}``" in doc, entry
        assert reason, entry
        if entry.endswith("=)"):          # a keyword of a function or class
            where, kw = entry[:-2].split("(")
            assert kw in params_of(resolve("projected_lmc_tpu", where)), entry
            assert kw not in params_of(resolve("projected_lmc_tpu_torch",
                                               where)), entry
        else:
            resolve("projected_lmc_tpu", entry)
            with pytest.raises(AttributeError):
                resolve("projected_lmc_tpu_torch", entry)


def test_import_is_light():
    code = (
        "import sys\n"
        "import projected_lmc_tpu_torch as pl\n"
        "from projected_lmc_tpu_torch.ops import _build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'pandas', 'matplotlib', 'projected_lmc_tpu'))\n"
        "assert not bad, bad\n"
        "assert _build.library.cache_info().currsize == 0\n"
        "assert 'projected_lmc_tpu_torch.experiments.plots' not in "
        "sys.modules\n"
        "print('light', pl.__version__)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"light {jpl.__version__}"


def test_examples_torch_import_no_jax():
    jax_names = sorted(os.listdir(os.path.join(REPO, "examples")))
    names = sorted(f for f in os.listdir(os.path.join(REPO, "examples_torch"))
                   if f.endswith(".py"))
    assert names == [f for f in jax_names if f.endswith(".py")]
    for name in names:
        path = os.path.join(REPO, "examples_torch", name)
        tree = ast.parse(open(path).read())
        roots = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots.add(node.module.split(".")[0])
        assert not roots & {"jax", "jaxlib", "optax", "projected_lmc_tpu"}, \
            (name, roots)
        assert "projected_lmc_tpu_torch" in roots, name
        switches = [a.value for node in ast.walk(tree)
                    if isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) == "add_argument"
                    for a in node.args if isinstance(a, ast.Constant)]
        assert "--cpu" in switches, name
        assert "--cpu" in ast.get_docstring(tree), name


def test_symmetrize_exact():
    A = np.random.default_rng(0).standard_normal((3, 5, 5))
    got = pl.ops.symmetrize(torch.tensor(A, dtype=torch.float64))
    want = np.asarray(jchol.symmetrize(jnp.asarray(A)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert pl.ops.symmetrize is tchol.symmetrize


def test_scale_kernel_set_lengthscale():
    rng = np.random.default_rng(1)
    x1, x2 = rng.standard_normal((7, 3)), rng.standard_normal((5, 3))
    value = rng.uniform(0.3, 2.0, (2, 1, 3))
    jk = jker.ScaleKernel(jker.MaternKernel(nu=2.5, ard_num_dims=3,
                                            batch_shape=2, dtype=jnp.float64),
                          dtype=jnp.float64)
    jk = jk.set_lengthscale(jnp.asarray(value))
    tk = pl.ScaleKernel(pl.MaternKernel(nu=2.5, ard_num_dims=3, batch_shape=2,
                                        dtype=torch.float64, device="cpu"),
                        dtype=torch.float64)
    assert tk.set_lengthscale(value) is tk
    np.testing.assert_allclose(tk.lengthscale.detach().numpy(), value,
                               rtol=1e-12)
    with torch.no_grad():
        got = tk(torch.tensor(x1), torch.tensor(x2)).numpy()
    want = np.asarray(jk(jnp.asarray(x1), jnp.asarray(x2)))
    np.testing.assert_allclose(got, want, rtol=1e-6)

    jspline = jker.ScaleKernel(jker.SplineKernel(batch_shape=2))
    tspline = tker.ScaleKernel(tker.SplineKernel(batch_shape=2,
                                                 dtype=torch.float64,
                                                 device="cpu"),
                               dtype=torch.float64)
    with pytest.raises(AttributeError):
        jspline.set_lengthscale(1.0)
    with pytest.raises(AttributeError):
        tspline.set_lengthscale(1.0)


def test_with_task_covar_factor():
    L = np.random.default_rng(2).standard_normal((4, 2))
    jl = jlik.MultitaskGaussianLikelihood(4, rank=2, dtype=jnp.float64)
    want = np.asarray(jl.with_task_covar_factor(L).task_covariance())
    tl = tlik.MultitaskGaussianLikelihood(4, rank=2, dtype=torch.float64,
                                          device="cpu")
    assert tl.with_task_covar_factor(L) is tl
    with torch.no_grad():
        got = tl.task_covariance().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(tl.task_noise_covar_factor.detach().numpy(),
                                  L)
    with pytest.raises(AttributeError):
        jlik.MultitaskGaussianLikelihood(4, rank=0).with_task_covar_factor(L)
    with pytest.raises(AttributeError):
        tlik.MultitaskGaussianLikelihood(4, rank=0, device="cpu") \
            .with_task_covar_factor(L)


def test_mixing_matrix_and_aliases():
    assert pl.LMCMixingMatrix is tprojected.LMCMixingMatrix
    assert pl.models.LMCMixingMatrix is tprojected.LMCMixingMatrix
    assert pl.handle_covar_ is tker.handle_covar
    assert pl.ProjectedLMCmll is pl.mlls.projected_lmc_mll
    assert pl.LeaveOneOutPseudoLikelihood is pl.mlls.loo_pseudo_likelihood
    assert pl.__version__ == jpl.__version__ == "0.1.0"
    assert pl.utils.ensure_cuda is pl.utils.device.ensure_cuda
