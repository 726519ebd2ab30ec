"""The port's Symbol against the JAX package's, on the CPU.

- ``tojson()`` is byte-equal for LeNet, ResNet-50 (the conv7 and the s2d
  stems) and ResNet-small, each
  built inside a fresh ``NameManager`` in both packages (ResNet's unnamed
  ``Flatten`` and ``+`` take their names from a per-process counter);
- ``infer_shape`` and the ``list_*`` results are equal;
- the port's ``load_json`` of the JAX package's JSON gives the same JSON;
- every op the port registers has the JAX op's name, parameter fields
  (type, default, required, enum), inputs, outputs, aux states and
  ``need_rng``, so graphs of those ops serialise alike and draw alike;
- the pure copies (``attribute.py``, ``name.py``, ``metric.py``,
  ``lr_scheduler.py``, ``models/lenet.py``, ``models/resnet.py``) equal
  their originals.
"""
from pathlib import Path

import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import registry as reg_j
from mxnet_tpu_torch.ops import registry as reg_t

ROOT = Path(__file__).resolve().parents[1]

MODELS = {
    "lenet": (lambda pkg: pkg.models.get_lenet(), {"data": (8, 1, 28, 28)}),
    "resnet50": (lambda pkg: pkg.models.get_resnet(1000, 50),
                 {"data": (2, 3, 224, 224)}),
    "resnet50_s2d": (lambda pkg: pkg.models.get_resnet(1000, 50,
                                                       stem="s2d"),
                     {"data": (2, 3, 224, 224)}),
    "resnet_small": (lambda pkg: pkg.models.get_resnet_small(),
                     {"data": (4, 3, 28, 28)}),
}


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for key, (build, _) in MODELS.items():
        with mj.NameManager():
            sj = build(mj)
        with mt.NameManager():
            st = build(mt)
        out[key] = (sj, st)
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
def test_tojson_bytes_equal(graphs, model):
    sj, st = graphs[model]
    assert st.tojson() == sj.tojson()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_lists_and_infer_shape_equal(graphs, model):
    sj, st = graphs[model]
    assert st.list_arguments() == sj.list_arguments()
    assert st.list_outputs() == sj.list_outputs()
    assert st.list_auxiliary_states() == sj.list_auxiliary_states()
    shapes = MODELS[model][1]
    assert st.infer_shape(**shapes) == sj.infer_shape(**shapes)
    assert st.infer_type(data="float32") == sj.infer_type(data="float32")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_load_json_round_trips(graphs, model):
    sj, _ = graphs[model]
    text = sj.tojson()
    assert mt.sym.load_json(text).tojson() == text


def test_arithmetic_nodes_serialise_alike():
    outs = []
    for pkg in (mj, mt):
        with pkg.NameManager():
            a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
            s = pkg.sym.Group([a + b, a - 1.5, 2 * b, a / b, 1 / a, -a])
        outs.append(s.tojson())
    assert outs[0] == outs[1]


def _fields(op):
    return [(k, f.type, f.default, f.required, f.enum)
            for k, f in op.param_fields.items()]


@pytest.mark.parametrize("name", sorted(reg_t.REGISTRY))
def test_registered_op_matches_jax(name):
    ot, oj = reg_t.REGISTRY[name], reg_j.REGISTRY[name]
    assert ot.name == oj.name
    assert _fields(ot) == _fields(oj)
    params = ot.parse_params(
        {k: {"shape": (3, 3), "int": 4, "str": (f.enum or ["x"])[0],
             "float": 1.0}[f.type]
         for k, f in ot.param_fields.items() if f.required})
    assert ot.list_arguments(params) == oj.list_arguments(params)
    assert ot.list_outputs(params) == oj.list_outputs(params)
    assert ot.list_auxiliary_states(params) == oj.list_auxiliary_states(params)
    assert ot.head_no_grad(params) == oj.head_no_grad(params)
    assert ot.need_rng == oj.need_rng


@pytest.mark.parametrize("path", ["attribute.py", "name.py", "metric.py",
                                  "lr_scheduler.py", "models/lenet.py",
                                  "models/resnet.py"])
def test_host_copy_matches_original(path):
    assert (ROOT / "mxnet_tpu_torch" / path).read_text() == \
        (ROOT / "mxnet_tpu" / path).read_text()
