"""The team judge (judges/team_decisions.py) and its plain references
(reference/slidematch.py, slidegraph.py, merges.py) on every closure and
merge decision of a small mission of the port on the CPU.

The mission's decisions are kept as their inputs (team_mission.py, which
records them again from the mission) and replayed through the program's
entry points and merge acceptance under the capture
(drivers/team_capture.py): 2 SlideGraph searches, 2 inter and 1 intra
SlideMatch searches, 4 merge calls accepting 2 merges, 2 polishes. The
program's decisions read 0 against the reference; the reference agrees
with the JAX package on the same inputs; the control (the reference with
its positions in bf16) and each planted fault read over a limit; the
merge calls of two episodes under one capture are judged node instance by
node instance.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import team_mission  # noqa: E402

def _modules():
    from slide_slam_tpu_torch.place_recognition import slidegraph, slidematch
    from slide_slam_tpu_torch.runtime import node
    return slidematch, slidegraph, node


class _Node:
    """What a node's merge acceptance and merge polish read of a SlamNode:
    its settings, its robot id, the peers it holds, what it has pending
    and the two maps a polish fits."""

    def __init__(self, cfg, rid, slam_node):
        self.cfg, self.robot_id, self._slam_node = cfg, rid, slam_node
        self.maps = {}
        self.dbm = types.SimpleNamespace(
            loop_closure_tf={},
            get_robot_map=lambda r: self.maps.get(r, np.zeros((0, 7),
                                                              np.float32)))
        self._pending_inter_tf = {}
        self.num_success_inter = 0
        self._tf_consistent = types.MethodType(slam_node._tf_consistent,
                                               self)

    def _refine_inter_tf(self, rid, tf7):
        # looked up on each call, so that a capture installed meanwhile
        # keeps the polish
        return self._slam_node._refine_inter_tf(self, rid, tf7)


def _replay_merges(cfg, node, calls, polishes):
    """`calls` through the program's merge acceptance, each robot's on a
    new node: one episode."""
    nodes = {}
    for m in calls:
        n = nodes.setdefault(m["node"], _Node(cfg, m["node"], node.SlamNode))
        n.dbm.loop_closure_tf = {k: None for k in m["known"]}
        for rid, _ in m["found"]:
            r = polishes.get((m["instance"], rid))
            if r is not None:
                n.maps = {m["node"]: r["own"], rid: r["peer_map"]}
        node.SlamNode._apply_inter_result(n, dict(m["found"]))


def _replay(cfg, data, episodes=None):
    """Every kept search and merge call through the program again, under a
    new capture: (the new record). `episodes` lists the merge calls of each
    episode (default: the mission's, once)."""
    from slambench.drivers import team_capture
    sm, sg, node = _modules()
    polishes = {(r["instance"], r["peer"]): r for r in data["refines"]}
    cap = team_capture.Capture().install(sm, sg, node)
    try:
        pr = sm.PlaceRecognition(cfg.place_recognition, device="cpu")
        graph = sg.SlideGraph(cfg.slidegraph, device="cpu")
        for s in data["searches"]:
            i = s["inputs"]
            if s["kind"] == "slidematch_intra":
                pr.find_intra_loop_closure(i["measurements"], i["submap"],
                                           i["query_pose"],
                                           i["candidate_pose"])
            elif s["kind"] == "slidematch_inter":
                pr.find_inter_loop_closure(i["reference_map"],
                                           i["query_map"])
            else:
                graph.find_inter_loop_closure(i["reference_map"],
                                              i["query_map"], i["seed"])
        for calls in episodes or [data["merges"]]:
            _replay_merges(cfg, node, calls, polishes)
    finally:
        cap.close()
    return cap.rec


@pytest.fixture(scope="module")
def recorded():
    """(the program's SlamConfig, the judge's settings, the kept inputs,
    the replay's record)."""
    from slambench.drivers import team_capture
    from slide_slam_tpu_torch import config
    cfg = config.SlamConfig(number_of_robots=2)
    data = team_mission.load()
    return cfg, team_capture.settings(cfg), data, _replay(cfg, data)


def _judge(settings, rec, side=None):
    from slambench.judges import team_decisions as J
    from slambench.run import verdict
    cfg = {"closures": settings}
    if side is None:
        side = J.program_side({"closures": rec})
    values = J.readings(cfg, {"limits": J.LIMITS}, None, side)
    return verdict(values, J.LIMITS) + (values,)


def test_every_decision_of_the_program_reads_zero(recorded):
    _, settings, _, rec = recorded
    ok, rows, values = _judge(settings, rec)
    assert ok, (rows, values)
    assert values["decision_mismatch"] == 0
    assert values["merge_mismatch"] == 0
    # the mission reaches every kind of decision, and each is decided
    for kind, n in (("slidematch_intra", 1), ("slidematch_inter", 2),
                    ("slidegraph", 2)):
        assert values[f"_{kind}_decided"] == n, values
        assert values[f"_{kind}_agree"] == n
    assert values["_merges_accepted"] == 2
    assert values["_merge_calls"] == 4
    assert values["_polishes"] == 2


def test_the_bf16_control_reads_over_a_limit(recorded):
    from slambench.judges import team_decisions as J
    from slambench.reference import precision
    _, settings, _, rec = recorded
    cfg = {"closures": settings}
    prog = J.program_side({"closures": rec})
    side = J.control_side(cfg, {"limits": J.LIMITS}, None, prog,
                          precision.bf16)
    ok, rows, values = _judge(settings, None, side)
    assert not ok, rows
    assert values["decision_mismatch"] > 0 or \
        values["closure_tf_gap_m"] > J.LIMITS["closure_tf_gap_m"]


def test_episodes_of_one_capture_are_judged_apart(recorded):
    """Two episodes under one capture, their nodes with the same robot ids:
    the first ends with each robot's first detection pending, the second
    starts with nothing pending, as a new node does. Judged node instance
    by node instance they read 0; judged by robot id, the second
    episode's first detections would be taken as confirmations."""
    cfg, settings, data, _ = recorded
    first = data["merges"][:2]
    assert all(m["found"] for m in first)
    rec = _replay(cfg, dict(data, searches=[]),
                  episodes=[first, data["merges"]])
    assert len({m["instance"] for m in rec["merges"]}) == 4
    ok, rows, values = _judge(settings, rec)
    assert ok, (rows, values)
    assert values["_merge_calls"] == 6 and values["_merges_accepted"] == 2
    by_robot = dict(rec, merges=[dict(m, instance=m["node"])
                                 for m in rec["merges"]])
    assert _judge(settings, by_robot)[2]["merge_mismatch"] > 0


def _every_other_yaw(sm, sg, node, monkeypatch):
    orig = sm._yaw_candidates

    def fault(half, step, disable, n_max):
        ys = np.unique(orig(half, step, disable, n_max))[::2]
        out = np.full((n_max,), ys[-1], np.float32)
        out[:len(ys)] = ys
        return out
    monkeypatch.setattr(sm, "_yaw_candidates", fault)


def _clipper_one_iteration(sm, sg, node, monkeypatch):
    from slide_slam_tpu_torch.place_recognition import clipper
    orig = clipper.find_dense_clique

    def fault(M, u0, params):
        return orig(M, u0, params._replace(maxoliters=1, maxiniters=1))
    monkeypatch.setattr(clipper, "find_dense_clique", fault)


def _accept_at_first_detection(sm, sg, node, monkeypatch):
    orig = node.SlamNode._apply_inter_result

    def fault(self, found):
        cfg = self.cfg
        self.cfg = cfg.replace(inter_tf_confirmations=1)
        try:
            return orig(self, found)
        finally:
            self.cfg = cfg
    monkeypatch.setattr(node.SlamNode, "_apply_inter_result", fault)


@pytest.mark.parametrize("plant", (_every_other_yaw,
                                   _clipper_one_iteration,
                                   _accept_at_first_detection),
                         ids=("every_other_yaw", "clipper_one_iteration",
                              "accept_at_first_detection"))
def test_a_planted_fault_reads_over_a_limit(recorded, plant, monkeypatch):
    cfg, settings, data, _ = recorded
    plant(*_modules(), monkeypatch)
    ok, rows, values = _judge(settings, _replay(cfg, data))
    assert not ok, (rows, values)


def test_the_references_agree_with_the_jax_package(recorded):
    """The JAX package's searches and merge rule on the recorded inputs
    decide as the references do, its transforms within the limits."""
    from slambench.judges import team_decisions as J
    from slambench.reference import merges
    from slambench.reference.precision import exact
    from slide_slam_tpu import config as jconfig
    from slide_slam_tpu.place_recognition.slidegraph import SlideGraph
    from slide_slam_tpu.place_recognition.slidematch import PlaceRecognition
    from slide_slam_tpu.runtime.node import SlamNode
    _, settings, _, rec = recorded
    limits = J.LIMITS
    pr = PlaceRecognition(jconfig.PlaceRecognitionConfig(
        **settings["place_recognition"]))
    graph = SlideGraph(jconfig.SlideGraphConfig(**settings["slidegraph"]))
    compared = 0
    for s in rec["searches"]:
        i = s["inputs"]
        if s["kind"] == "slidegraph":
            r = J._reference_slidegraph(s, settings, exact)
            want, want_tf = r.found, r.tf
            got, got_tf = graph.find_inter_loop_closure(
                i["reference_map"], i["query_map"], i["seed"])
        elif s["kind"] == "slidematch_intra":
            want, want_tf, r = J._reference_slidematch(s, settings, exact)
            got, got_tf, fit = pr.find_intra_loop_closure(
                i["measurements"], i["submap"], i["query_pose"],
                i["candidate_pose"])
            if want:
                assert fit[0] == r.fit[0]
        else:
            want, want_tf, r = J._reference_slidematch(s, settings, exact)
            got, got_tf = pr.find_inter_loop_closure(i["reference_map"],
                                                     i["query_map"])
        assert got == want
        if want:
            g, a = J.tf_gap(np.asarray(got_tf, np.float64), want_tf)
            assert g <= limits["closure_tf_gap_m"], (s["kind"], g)
            assert a <= limits["closure_yaw_gap_rad"], (s["kind"], a)
            compared += 1
    assert compared == len(rec["searches"])
    jcfg = jconfig.SlamConfig(**{k: settings["merge"][k] for k in (
        "inter_tf_confirmations", "inter_tf_confirm_pos",
        "inter_tf_confirm_yaw_deg")})
    for calls in J._by_node(rec["merges"]):
        want, _ = merges.accepted_merges(calls, settings["merge"])
        n = _Node(jcfg, calls[0]["node"], SlamNode)
        for m, w in zip(calls, want):
            n.dbm.loop_closure_tf = {k: None for k in m["known"]}
            assert SlamNode._apply_inter_result(n, dict(m["found"])) == w
            assert m["accepted"] == w


def test_settings_state_the_programs_own():
    """The judge's settings name every field of the program's closure
    configuration, so that a configuration file can state them all."""
    from slambench.drivers import team_capture
    from slide_slam_tpu_torch import config
    cfg = config.SlamConfig()
    s = team_capture.settings(cfg)
    assert s["place_recognition"] == dataclasses.asdict(
        cfg.place_recognition)
    assert s["slidegraph"] == dataclasses.asdict(cfg.slidegraph)
    assert s["merge"]["inter_tf_confirmations"] == 2
    assert s["max_associations"] == 2048


def test_gated_searches_agree_and_are_counted():
    """Below the entry points' gates (fewer than 4 measurements, too few
    map objects) neither side searches, and the judge holds them so."""
    from slambench.drivers import team_capture
    from slide_slam_tpu_torch import config
    cfg = config.SlamConfig()
    rng = np.random.default_rng(3)
    objs = np.zeros((20, 7), np.float32)
    objs[:, 0] = 8
    objs[:, 1:3] = rng.uniform(-10, 10, (20, 2))
    pose = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    sm, sg, node = _modules()
    cap = team_capture.Capture().install(sm, sg, node)
    try:
        pr = sm.PlaceRecognition(cfg.place_recognition, device="cpu")
        pr.find_intra_loop_closure(objs[:3], objs, pose, pose)
        pr.find_intra_loop_closure(objs, objs[:0], pose, pose)
        pr.find_inter_loop_closure(objs, objs[:4])
        sg.SlideGraph(cfg.slidegraph, device="cpu").find_inter_loop_closure(
            objs, objs)
    finally:
        cap.close()
    ok, rows, values = _judge(team_capture.settings(cfg), cap.rec)
    assert ok, (rows, values)
    assert values["_slidematch_intra_decided"] == 2
    assert values["_slidematch_inter_decided"] == 1
    assert values["_slidegraph_decided"] == 1
