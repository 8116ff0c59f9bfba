"""The judge of the program's graphs against the reference's own
construction, on the tiny configuration."""

import numpy as np
import pytest

from conftest import tiny_config
from portbench.harness import check, system
from portbench.reference import mesh


@pytest.fixture(scope="module")
def graphs(spec):
    import json
    import os

    from conftest import REPO
    from graphcast_lite_torch.graphs.build import build_graph_set

    with open(os.path.join(REPO, "portbench", "configs", "flagship.json")) as f:
        cfg = tiny_config(json.load(f))
    lat, lon = system.grid_axes(cfg)
    gs = build_graph_set(lat, lon, cfg["graph"]["mesh_levels"],
                         cfg["graph"]["grid2mesh_radius_query"])
    return mesh.build_graphs(cfg), check.program_edges(gs)


def test_the_programs_graphs_pass(graphs):
    ref, prog = graphs
    faults, adopted = check.judge_graphs(ref, prog)
    assert faults == 0
    assert adopted["dec"][0].size == 3 * ref["num_grid"]


def test_a_lost_mesh_edge_is_a_fault(graphs):
    ref, prog = graphs
    s, r = prog["proc"]
    bad = dict(prog, proc=(s[1:], r[1:]))
    assert check.judge_graphs(ref, bad)[0] >= 1


def test_a_wrong_decoder_vertex_is_a_fault(graphs):
    ref, prog = graphs
    s, r = (a.copy() for a in prog["dec"])
    far = ref["num_grid"] + ref["num_mesh"] - 1
    s[np.flatnonzero(s != far)[0]] = far
    assert check.judge_graphs(ref, dict(prog, dec=(s, r)))[0] >= 1


def test_a_far_encoder_edge_is_a_fault(graphs):
    ref, prog = graphs
    s, r = prog["enc"]
    far = dict(prog, enc=(np.append(s, 0), np.append(r, r.max())))
    assert check.judge_graphs(ref, far)[0] >= 1
