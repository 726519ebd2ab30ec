"""Network visualization (ref: python/mxnet/visualization.py:1-288)."""
from __future__ import annotations

import json

from .symbol import Symbol


def print_summary(symbol, shape=None, line_length=120, positions=(0.44, 0.64, 0.74, 1.0)):
    """Print a layer summary table (ref: visualization.py:14)."""
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be a Symbol")
    show_shape = False
    shape_dict = {}
    if shape is not None:
        show_shape = True
        _, out_shapes, _ = symbol.get_internals().infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_dict = dict(zip(symbol.get_internals().list_outputs(), out_shapes))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    if positions[-1] <= 1:
        positions = [int(line_length * p) for p in positions]
    to_display = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(fields, positions):
        line = ""
        for i, field in enumerate(fields):
            line += str(field)
            line = line[: positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(to_display, positions)
    print("=" * line_length)

    total_params = [0]

    def print_layer_summary(node, out_shape):
        op = node["op"]
        pre_node = []
        for item in node["inputs"]:
            input_node = nodes[item[0]]
            input_name = input_node["name"]
            if input_node["op"] != "null" or item[0] in heads:
                pre_node.append(input_name)
        cur_param = 0
        if op == "Convolution":
            ks = _tup(node["param"]["kernel"])
            cur_param = int(node["param"]["num_filter"])
            pre_filter = 0
            for item in node["inputs"]:
                nm = nodes[item[0]]["name"]
                if nm.endswith("weight") and nm in shape_dict0:
                    cur_param = 1
                    for d in shape_dict0[nm]:
                        cur_param *= d
            for item in node["inputs"]:
                nm = nodes[item[0]]["name"]
                if nm.endswith("bias") and nm in shape_dict0:
                    cur_param += shape_dict0[nm][0]
        elif op == "FullyConnected":
            for item in node["inputs"]:
                nm = nodes[item[0]]["name"]
                if nm in shape_dict0:
                    p = 1
                    for d in shape_dict0[nm]:
                        p *= d
                    cur_param += p
        name = node["name"]
        first_connection = pre_node[0] if pre_node else ""
        fields = [
            name + " (" + op + ")",
            str(out_shape) if out_shape is not None else "",
            cur_param,
            first_connection,
        ]
        print_row(fields, positions)
        for i in range(1, len(pre_node)):
            fields = ["", "", "", pre_node[i]]
            print_row(fields, positions)
        total_params[0] += cur_param

    # map arg shapes for param counting
    shape_dict0 = {}
    if show_shape:
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape)
        shape_dict0 = dict(zip(symbol.list_arguments(), arg_shapes))
        shape_dict0.update(dict(zip(symbol.list_auxiliary_states(), aux_shapes)))
    heads = set(h[0] for h in conf["heads"])
    internals = symbol.get_internals()
    out_names = internals.list_outputs() if show_shape else []
    for i, node in enumerate(nodes):
        if node["op"] == "null":
            continue
        out_shape = None
        if show_shape:
            key = node["name"] + "_output"
            if key in shape_dict:
                out_shape = shape_dict[key]
        print_layer_summary(node, out_shape)
        print("_" * line_length)
    print("Total params: {}".format(total_params[0]))
    print("_" * line_length)


def _tup(s):
    import ast

    return tuple(ast.literal_eval(s))


def plot_network(symbol, title="plot", shape=None, node_attrs=None):
    """Graphviz network plot (ref: visualization.py:156). Requires the
    optional graphviz package; raises a clear error otherwise."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError("plot_network requires the graphviz python package") from e
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    dot = Digraph(name=title)
    for i, node in enumerate(nodes):
        name = node["name"]
        if node["op"] == "null":
            dot.node(name=name, label=name, shape="oval")
        else:
            dot.node(name=name, label="%s\n%s" % (name, node["op"]), shape="box")
    for i, node in enumerate(nodes):
        for item in node["inputs"]:
            dot.edge(nodes[item[0]]["name"], node["name"])
    return dot
