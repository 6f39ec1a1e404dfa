"""The port's bench suite takes the reference's command line and writes
its report.

The reference (gpuraytracer_tpu/apps/bench_suite.py) is read as source with
``ast``, never imported: its ``add_argument`` calls give each flag's type
and default, its ``bench_config`` signature the parameters' defaults, its
``out`` dict the keys it always writes and its ``out[...] =`` assignments
under ``if device_time and chain > 1`` the keys of the device-time slope,
with that condition. The command lines that the repository writes for the
reference (tools/round_end.sh, README.md, the reference's usage line) are
read from those files and must parse. The runs are on the CPU at a tiny
size, one scene, under a second each.
"""

import argparse
import ast
import builtins
import inspect
import json
import os
import re
import shlex

import pytest

from gpuraytracer_tpu_torch.apps import bench_suite
from gpuraytracer_tpu_torch.utils import stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PATH = os.path.join(ROOT, "gpuraytracer_tpu", "apps", "bench_suite.py")
REF_MODULE = "gpuraytracer_tpu.apps.bench_suite"
with open(REF_PATH) as _f:
    REF_TREE = ast.parse(_f.read())
TINY = ["--device", "cpu", "--configs", "single_sphere_plane_256", "--scale", "0.05",
        "--frames", "1", "--reps", "1", "--wall-chain", "2"]


def _function(name):
    return next(n for n in REF_TREE.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _reference_flags():
    """(flag, type name or None, default, action or None) of each
    add_argument call in the reference's main."""
    flags = []
    for node in ast.walk(_function("main")):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            flags.append((node.args[0].value,
                          kw["type"].id if "type" in kw else None,
                          ast.literal_eval(kw["default"]) if "default" in kw else None,
                          ast.literal_eval(kw["action"]) if "action" in kw else None))
    return flags


def _reference_parameters():
    """bench_config's parameters with a default, and those defaults."""
    args = _function("bench_config").args
    return list(zip([a.arg for a in args.args[-len(args.defaults):]],
                    [ast.literal_eval(d) for d in args.defaults]))


def _reference_keys():
    """(keys always written, keys written under the device-time condition,
    that condition's source)."""
    fn = _function("bench_config")
    always = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", "") == "out")
    gate = next(n for n in fn.body if isinstance(n, ast.If) and any(
        isinstance(t, ast.Subscript) for a in ast.walk(n) if isinstance(a, ast.Assign)
        for t in a.targets))
    conditional = {t.slice.value for n in ast.walk(gate) if isinstance(n, ast.Assign)
                   for t in n.targets if isinstance(t, ast.Subscript)}
    return [k.value for k in always.keys], conditional, ast.unparse(gate.test)


def _written_command_lines():
    """The reference bench's command lines as the repository writes them:
    round_end's and the README's invocations, and the usage line of the
    reference's docstring (its optional flags with their example values)."""
    lines = {}
    for name, path in (("round_end", "tools/round_end.sh"), ("readme", "README.md")):
        with open(os.path.join(ROOT, path)) as f:
            found = [m.group(1) for m in re.finditer(
                r"python -m " + re.escape(REF_MODULE) + r"([^\n]*)", f.read())]
        assert found, path
        lines[name] = shlex.split(found[0])
    usage = ast.get_docstring(REF_TREE).split("Usage:")[1]
    lines["usage"] = shlex.split(usage.replace(f"python -m {REF_MODULE}", "")
                                 .replace("[", " ").replace("]", " "))
    return lines


@pytest.mark.parametrize("flag,type_name,default,action", _reference_flags(),
                         ids=[f[0] for f in _reference_flags()])
def test_parser_takes_the_reference_flag(flag, type_name, default, action):
    parser = bench_suite.build_parser()
    dest = flag.lstrip("-").replace("-", "_")
    if action == "store_true":
        assert getattr(parser.parse_args([]), dest) is False
        assert getattr(parser.parse_args([flag]), dest) is True
        return
    assert getattr(parser.parse_args([]), dest) == default
    value = getattr(parser.parse_args([flag, "3"]), dest)
    assert type(value) is getattr(builtins, type_name) and value == getattr(builtins, type_name)("3")


@pytest.mark.parametrize("name,default", _reference_parameters(),
                         ids=[p[0] for p in _reference_parameters()])
def test_bench_config_takes_the_reference_parameter(name, default):
    assert inspect.signature(bench_suite.bench_config).parameters[name].default == default


def test_usage_line_lists_every_reference_flag():
    usage = bench_suite.__doc__.split("Usage")[1]
    for flag, *_ in _reference_flags():
        assert f"[{flag}" in usage, flag


def test_reference_keys_are_the_references():
    always, conditional, _ = _reference_keys()
    assert list(bench_suite.REFERENCE_KEYS) == always
    assert set(bench_suite.DEVICE_TIME_KEYS) | {"device_frame_ms_below_resolution"} == conditional


@pytest.mark.parametrize("extra", [[], ["--no-device-time"], ["--chain", "1"],
                                   ["--warmup", "2", "--chain", "4"]],
                         ids=["default", "no_device_time", "chain_1", "warmup_2_chain_4"])
def test_report_has_the_reference_keys(tmp_path, extra):
    out = str(tmp_path / "bench.json")
    assert bench_suite.main(TINY + extra + ["--json", out]) == 0
    with open(out) as f:
        (line,) = json.load(f)
    always, conditional, condition = _reference_keys()
    args = bench_suite.build_parser().parse_args(TINY + extra)
    timed = eval(condition, {}, {"device_time": not args.no_device_time, "chain": args.chain})
    assert set(always) <= set(line)
    assert "first_frame_s" not in line
    assert line["frame_ms"] > 0 and line["frame_ms_min"] <= line["frame_ms"] <= line["frame_ms_max"]
    assert line["compile_s"] == round(line["compile_s"], 1)
    assert line["frame_ms_events"] is None  # no CUDA events on the CPU
    assert line["launches_per_frame"]["frame_kernel"] == 0.0  # plain on the CPU
    if not timed:
        assert not conditional & set(line)
        return
    assert set(bench_suite.DEVICE_TIME_KEYS) <= set(line)
    assert line["device_frame_ms"] >= 1e-3
    if line["device_frame_ms"] < bench_suite.RESOLUTION_MS:
        assert line["device_frame_ms_below_resolution"] is True
        assert line["mrays_dispatch"] is None
    else:
        assert "device_frame_ms_below_resolution" not in line
        # mrays_dispatch is W * H / (d * 1e3) of the unrounded device time d,
        # rounded to 3 decimals, and device_frame_ms is d rounded to 3
        # decimals, D (>= RESOLUTION_MS here). From D the value is exact to
        # within the two roundings: 5e-4 for its own, and for D's, |D - d| <=
        # 5e-4 moves W * H / (x * 1e3) by at most W * H / 1e3 * 5e-4 /
        # (D * (D - 5e-4)); 1e-9 covers the float arithmetic. A slow host
        # makes the value small (0.0 past about 288 ms at 12x12), not wrong.
        half = 5e-4
        d_ms = line["device_frame_ms"]
        want = stats.mrays_per_second_from_dispatch_ms(line["width"], line["height"], d_ms)
        err = half + line["width"] * line["height"] / 1e3 * half / (d_ms * (d_ms - half))
        assert abs(line["mrays_dispatch"] - want) <= err + 1e-9, (line["mrays_dispatch"], want, err)


def test_warmup_flag_runs():
    # The reference's --warmup once made the port's main exit 2.
    assert bench_suite.main(["--warmup", "1"] + TINY) == 0


@pytest.mark.parametrize("name", ["round_end", "readme", "usage"])
def test_written_command_line_parses(name):
    argv = _written_command_lines()[name]
    args = bench_suite.build_parser().parse_args(argv)
    assert isinstance(args, argparse.Namespace)
    given = {a.lstrip("-").replace("-", "_") for a in argv if a.startswith("--")}
    defaults = dict((f.lstrip("-").replace("-", "_"), d) for f, _, d, _ in _reference_flags())
    for dest, default in defaults.items():
        if dest not in given and dest != "no_device_time":
            assert getattr(args, dest) == default, dest
    assert args.device == "cuda" and not args.ab_roots
