"""The port's one CUDA-graph capture mechanism (``utils/cuda_graph.py``).

On the CPU (tier 1): the ownership rule (a static buffer comes back as the
caller's tensor, a graph tensor as one clone however often it appears, a
foreign tensor as itself), the static-input check (a shape or dtype that
is not its buffer's raises ``ValueError`` naming the field, for the
tracker state's fields and PnP's ``uniforms``), the loader's copies and
fills, and the keyed cache's CPU path (the eager function, nothing made
or captured).

On the card (``cuda`` marker): a chain broken at one launch replays the
launch between its graphs, and a dry replay leaves the break's outputs as
they are. The users' graph = eager cases are in ``test_torch_cuda.py`` and
``test_torch_pnp_graph.py``. This file imports no JAX.
"""

from __future__ import annotations

import pytest
import torch

from thor_slam_tpu_torch.engine import tracker as trk
from thor_slam_tpu_torch.utils import cuda_graph

PARAMS = trk.TrackerParams(num_cams=2, height=32, width=48, max_keypoints=8)


def _tick_inputs(state: trk.TrackerState) -> dict:
    """The tree the graphed tick loads as ``"inputs"``."""
    setup = trk.CameraSetup(*(torch.zeros(2, 3) for _ in trk.CameraSetup._fields))
    images = torch.zeros((2, 2, PARAMS.height, PARAMS.width), dtype=torch.uint8)
    return dict(setup=setup, state=state, images=images, cam_active=torch.ones(2, dtype=torch.bool),
                pose_prediction=None)


def _pnp_inputs(uniforms: torch.Tensor | None, n: int = 16, hypotheses: int = 4) -> dict:
    """The tree the graphed PnP loads as ``"inputs"``."""
    g = torch.Generator().manual_seed(n)
    points = torch.rand((n, 3), generator=g) + torch.tensor([-0.5, -0.5, 2.0])
    return dict(points_w=points, obs=points[:, :2] / points[:, 2:], valid=torch.ones(n, dtype=torch.bool),
                cam_rot=torch.eye(3).expand(n, 3, 3).contiguous(), cam_trans=torch.zeros(n, 3),
                init_body_t_world=torch.eye(4),
                obs_weight=None, inlier_threshold=torch.zeros(()),
                uniforms=torch.zeros(hypotheses, n) if uniforms is None else uniforms)


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("kind", ["static", "graph", "alias", "foreign", "number"])
def test_ownership_rule(kind):
    static, mine = torch.zeros(3), torch.ones(3)
    graph = torch.arange(4.0)
    foreign = torch.full((2,), 7.0)
    callers = {id(static): mine}
    storages = cuda_graph.storages((static, graph))
    tree = {
        "static": (static,),
        "graph": (graph,),
        "alias": (graph, graph[1:], graph),
        "foreign": (foreign,),
        "number": (True, None),
    }[kind]
    owned = cuda_graph.own(tree, callers, storages)
    if kind == "static":
        assert owned[0] is mine
    elif kind == "graph":
        assert owned[0] is not graph and torch.equal(owned[0], graph)
        assert owned[0].untyped_storage().data_ptr() not in storages
    elif kind == "alias":  # one clone per tensor: the same tensor twice is one clone twice
        assert owned[0] is owned[2] and owned[0] is not graph
        assert owned[1] is not owned[0] and torch.equal(owned[1], graph[1:])
        assert owned[1].untyped_storage().data_ptr() not in storages
    elif kind == "foreign":
        assert owned[0] is foreign
    else:
        assert owned == (True, None)


def test_ownership_keeps_namedtuples():
    state = trk.init_state(PARAMS, "cpu")
    callers = {id(state.lm_pos_w): torch.ones(1)}
    owned = cuda_graph.own((state, 3), callers, cuda_graph.storages(state))
    assert type(owned[0]) is trk.TrackerState and owned[1] == 3
    assert owned[0].lm_pos_w is callers[id(state.lm_pos_w)]
    assert all(a is not b and torch.equal(a, b) for a, b in zip(owned[0][1:], state[1:])
               if a is not owned[0].lm_pos_w)


def _bad(t: torch.Tensor, how: str) -> torch.Tensor:
    return torch.zeros((*t.shape, 2), dtype=t.dtype) if how == "shape" else torch.zeros(t.shape, dtype=torch.float64)


@pytest.mark.parametrize("how", ["shape", "dtype"])
@pytest.mark.parametrize("field", ["state.lm_pos_w", "state.frame_idx", "state.lm_valid", "uniforms"])
def test_static_input_check_names_the_field(field, how):
    if field == "uniforms":
        good = _pnp_inputs(None)
        bad = _pnp_inputs(_bad(good["uniforms"], how))
    else:
        state = trk.init_state(PARAMS, "cpu")
        good = _tick_inputs(state)
        name = field.split(".")[1]
        bad = _tick_inputs(state._replace(**{name: _bad(getattr(state, name), how)}))
    entry = cuda_graph.Captured(torch.device("cpu"), good)
    entry.load("inputs", good)
    with pytest.raises(ValueError, match=rf"^{field} must be "):
        entry.load("inputs", bad)


def test_load_copies_fills_and_keeps_buffers():
    state = trk.init_state(PARAMS, "cpu")
    inputs = _tick_inputs(state)
    entry = cuda_graph.Captured(torch.device("cpu"), inputs)
    moved = state._replace(lm_pos_w=torch.randn_like(state.lm_pos_w))
    first = entry.load("inputs", {**inputs, "state": moved, "cam_active": False})
    assert torch.equal(first["state"].lm_pos_w, moved.lm_pos_w) and first["state"].lm_pos_w is not moved.lm_pos_w
    assert not first["cam_active"].any() and first["pose_prediction"] is None
    again = entry.load("inputs", {**inputs, "cam_active": True})
    assert again["state"].lm_pos_w is first["state"].lm_pos_w  # the same buffers every call
    assert bool(again["cam_active"].all()) and not again["state"].lm_pos_w.any()
    # Any other name's buffers take the shapes of its first load.
    extra = entry.load("result", (torch.arange(3), torch.ones(2, 2)))
    assert torch.equal(extra[0], torch.arange(3))
    with pytest.raises(ValueError, match=r"^1 must be \(2, 2\)"):
        entry.load("result", (torch.arange(3), torch.ones(2, 3)))


@pytest.mark.parametrize("user", ["cache", "pnp", "tracker"])
def test_cache_cpu_path_is_eager(user):
    """Off the card: the eager function's result, no entry made, nothing
    captured."""
    if user == "cache":
        cache = cuda_graph.GraphCache()

        def never(*_):
            raise AssertionError("made or replayed an entry off the card")

        assert cache.dispatch(("key",), torch.device("cpu"), lambda: 42, never, never) == 42
    elif user == "pnp":
        from thor_slam_tpu_torch.engine import pnp

        cache = pnp.GraphedRansacPnP()
        args = _pnp_inputs(None)
        res = cache(*(args[k] for k in ("points_w", "obs", "valid", "cam_rot", "cam_trans", "init_body_t_world")),
                    num_hypotheses=4, sample_size=3, generator=torch.Generator().manual_seed(0))
        assert isinstance(res, pnp.PnPResult)
    else:
        cache = trk.GraphedTrackStep()
        inputs = _tick_inputs(trk.init_state(PARAMS, "cpu"))
        assert cache.capture(PARAMS, inputs["setup"], inputs["state"], inputs["images"]) is None
    assert cache.captures == 0 and cache._entries == {}


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_chain_replays_the_launch_between_its_graphs(cuda_device):
    """``x -> launch(x + 1) -> * 2``: two graphs around one eager launch. A
    live replay runs the launch on the new input; a dry one leaves the
    break's output from the last live replay."""
    calls = []

    def launch(t):
        calls.append(1)
        return (t * 10,)

    entry = cuda_graph.Captured(cuda_device, {"x": torch.zeros(4, device=cuda_device)},
                                placeholder=lambda t: (torch.zeros_like(t),))
    chain = entry.chains[0]

    def run(x, live=True):
        s = entry.load("inputs", {"x": x})
        mode = entry.run(chain, lambda call: call(s["x"] + 1)[0] * 2, launch if live else None)
        return mode, chain.outputs.clone()

    x = torch.arange(4.0, device=cuda_device)
    mode, out = run(x)  # the warm-up and the capture launch nothing; the replay does
    assert mode == "capture" and torch.equal(out, (x + 1) * 20) and len(calls) == 1
    mode, out = run(x + 1)
    assert mode == "replay" and torch.equal(out, (x + 2) * 20) and len(calls) == 2
    mode, out = run(x + 5, live=False)
    assert torch.equal(out, (x + 2) * 20) and len(calls) == 2
    assert len(chain.graphs) == 2 and len(chain.breaks) == 1
