"""The OpenMDAO / CSDL adapter layers require optional packages not in
this image; at minimum their sources must stay syntactically valid and
their umbrella modules must fail ONLY on the missing dependency."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

ADAPTERS = [
    "goldfish_jax/om_comps/components.py",
    "goldfish_jax/csdl_models/models.py",
    "goldfish_jax/nonmatching_opt_om.py",
    "goldfish_jax/nonmatching_opt_csdl.py",
]


@pytest.mark.parametrize("rel", ADAPTERS)
def test_adapter_sources_parse(rel):
    ast.parse((ROOT / rel).read_text())


def test_umbrellas_fail_only_on_missing_dep():
    for mod, dep in [("goldfish_jax.nonmatching_opt_om", "openmdao"),
                     ("goldfish_jax.nonmatching_opt_csdl", "csdl_alpha")]:
        try:
            __import__(mod)
        except ModuleNotFoundError as e:
            assert dep in str(e), (mod, e)
