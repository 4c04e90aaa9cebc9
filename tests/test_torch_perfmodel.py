"""The port's analytical exchange models (``repro_torch.core.perfmodel``):
the reference's §3 claims hold, and every closed form returns exactly the
reference's number for the same inputs."""
import numpy as np
import pytest

from repro.core import perfmodel as rpm
from repro_torch.core import perfmodel as pm


@pytest.fixture
def h100():
    return pm.CLUSTERS["h100_ib"]


# ---------------------------------------------------------------------------
# the reference's claims (tests/test_perfmodel.py), on the port
# ---------------------------------------------------------------------------

def test_broadcast_throughput_decreases_with_v(h100):
    ths = [pm.broadcast_throughput(h100, v) for v in range(1, 9)]
    assert all(a >= b - 1e-6 for a, b in zip(ths, ths[1:]))
    assert ths[-1] == pytest.approx(
        64 / 63 * min(h100.bn / h100.k, h100.bg), rel=1e-6)


def test_shuffle_throughput_increases_with_v(h100):
    ss = [pm.shuffle_throughput(h100, v) for v in range(2, 9)]
    assert all(a <= b for a, b in zip(ss, ss[1:]))


def test_shuffle_vs_broadcast_v_times(h100):
    for v in (2, 4, 8):
        ratio = pm.shuffle_throughput(h100, v) / \
            pm.broadcast_throughput(h100, v)
        assert ratio > v / 2


def test_eq3_broadcast_beats_shuffle(h100):
    assert pm.broadcast_beats_shuffle(h100, 1, 1.0, 8.0)
    assert not pm.broadcast_beats_shuffle(h100, 1, 1.0, 6.9)
    wins = [pm.broadcast_beats_shuffle(h100, v, 1.0, 30.0)
            for v in (1, 8, 64)]
    assert wins[0] and wins[1] and not wins[2]


def test_skew_model_per_node_not_per_gpu(h100):
    n, k = 16, 8
    base = np.full((n, n), 1.0)
    t0 = pm.shuffle_time_skewed(*pm.node_send_recv(base, k), h100.bn)
    intra = base.copy()
    intra[0, :] += 0.5
    intra[7, :] -= 0.5
    t1 = pm.shuffle_time_skewed(*pm.node_send_recv(intra, k), h100.bn)
    assert t1 == pytest.approx(t0, rel=1e-9)
    inter = base.copy()
    inter[:8, :] *= 2
    t2 = pm.shuffle_time_skewed(*pm.node_send_recv(inter, k), h100.bn)
    assert t2 > t0 * 1.5


def test_hockney_fit_recovers_parameters():
    L, c = 12e-6, 1 / (25e9)
    ms = np.logspace(2, 9, 25)
    fit = pm.fit_hockney(ms, L + c * ms)
    assert fit.latency == pytest.approx(L, rel=1e-6)
    assert fit.inv_bw == pytest.approx(c, rel=1e-9)
    assert fit.bandwidth(1e9) < 25e9


def test_projection_shapes_match_paper(h100):
    proj = pm.project_workload(h100, range(1, 9), 1.0,
                               [("broadcast", 5e9), ("shuffle", 5e9)])
    assert proj[8]["compute"] < proj[1]["compute"]
    assert proj[8]["broadcast"] > proj[2]["broadcast"]


def test_small_messages_hurt(h100):
    fit = pm.Hockney(latency=20e-6, inv_bw=1 / h100.bn)
    t_small = pm.exchange_time("shuffle", h100, 4, 1e6, fit, fit)
    t_large = pm.exchange_time("shuffle", h100, 4, 1e10, fit, fit)
    assert (t_small / 1e6) > 5 * (t_large / 1e10)


def test_cluster_spec_live_width_changes_pricing():
    spec = pm.CLUSTERS["h100_eth"]
    assert spec.live_n(2) == 16
    s7 = spec.with_devices(7)
    assert s7.live_n(2) == 7 and s7.name == spec.name
    assert pm.broadcast_throughput(s7, 2) != pm.broadcast_throughput(spec, 2)
    assert pm.shuffle_throughput(s7, 2) == pm.shuffle_throughput(spec, 2)
    with pytest.raises(ValueError):
        spec.with_devices(0)


class _Stats:
    """The fields of an ``ExchangeStats`` the models read."""

    def __init__(self, kind, message_bytes, participants, row_wire=0,
                 row_logical=0):
        self.kind = kind
        self.message_bytes = message_bytes
        self.participants = participants
        self.row_wire_bytes = row_wire
        self.row_logical_bytes = row_logical


def test_exchange_time_from_stats_prefers_pinned_width():
    stats = _Stats("shuffle", 1 << 20, 8)
    spec = pm.CLUSTERS["h100_eth"]
    t8 = pm.exchange_time_from_stats(stats, spec, v=2)
    t4 = pm.exchange_time_from_stats(stats, spec.with_devices(4), v=2)
    assert t8 != t4
    assert pm.exchange_time_from_stats(stats, spec.with_devices(4), v=2,
                                       n_devices=8) == t8


# ---------------------------------------------------------------------------
# number for number against the reference
# ---------------------------------------------------------------------------

def test_clusters_equal_the_reference():
    assert sorted(pm.CLUSTERS) == sorted(rpm.CLUSTERS)
    for name, spec in pm.CLUSTERS.items():
        ref = rpm.CLUSTERS[name]
        assert [getattr(spec, f) for f in ref.__dataclass_fields__] == \
            [getattr(ref, f) for f in ref.__dataclass_fields__], name


def _specs():
    for name in sorted(rpm.CLUSTERS):
        for pin in (None, 5):
            yield name, pin


@pytest.mark.parametrize("name,pin", list(_specs()))
def test_closed_forms_equal_the_reference(name, pin):
    spec, ref = pm.CLUSTERS[name], rpm.CLUSTERS[name]
    if pin is not None:
        spec, ref = spec.with_devices(pin), ref.with_devices(pin)
    hp, hr = pm.Hockney(15e-6, 1 / 20e9), rpm.Hockney(15e-6, 1 / 20e9)
    for v in (1, 2, 3, 8):
        assert pm.broadcast_throughput(spec, v) == \
            rpm.broadcast_throughput(ref, v)
        assert pm.shuffle_throughput(spec, v) == \
            rpm.shuffle_throughput(ref, v)
        for r, s in ((1.0, 6.0), (1e6, 3e7), (2.0, 1.0)):
            assert pm.broadcast_beats_shuffle(spec, v, r, s) == \
                rpm.broadcast_beats_shuffle(ref, v, r, s)
        for kind in ("broadcast", "shuffle", "gather", "broadcast_p2p"):
            for nbytes in (1e3, 7.5e8):
                assert pm.exchange_time(kind, spec, v, nbytes) == \
                    rpm.exchange_time(kind, ref, v, nbytes)
                assert pm.exchange_time(kind, spec, v, nbytes, hp, hp) == \
                    rpm.exchange_time(kind, ref, v, nbytes, hr, hr)
        for kind in ("shuffle", "broadcast", "gather"):
            st = _Stats(kind, 123_456, 8)
            assert pm.exchange_time_from_stats(st, spec, v, None, hp) == \
                rpm.exchange_time_from_stats(st, ref, v, None, hr)
    exchanges = [("broadcast", 5e9), ("shuffle", 2e9), ("shuffle", 1e6)]
    assert pm.project_workload(spec, range(1, 6), 3.0, exchanges, hp, hp,
                               -0.8) == \
        rpm.project_workload(ref, range(1, 6), 3.0, exchanges, hr, hr, -0.8)


def test_fits_and_skew_equal_the_reference():
    rng = np.random.default_rng(11)
    ms = np.logspace(2, 9, 17)
    times = 9e-6 + ms / 31e9 + rng.normal(0, 1e-7, ms.shape)
    a, b = pm.fit_hockney(ms, times), rpm.fit_hockney(ms, times)
    assert (a.latency, a.inv_bw) == (b.latency, b.inv_bw)
    m = rng.uniform(0, 1e6, (16, 16))
    for k in (1, 4, 8):
        assert all(np.array_equal(x, y) for x, y in zip(
            pm.node_send_recv(m, k), rpm.node_send_recv(m, k)))
        s, r = pm.node_send_recv(m, k)
        assert pm.shuffle_time_skewed(s, r, 1e10) == \
            rpm.shuffle_time_skewed(s, r, 1e10)
    st = _Stats("shuffle", 10, 4, row_wire=12, row_logical=40)
    assert pm.wire_savings(st) == rpm.wire_savings(st) == 0.7
    assert pm.wire_savings(_Stats("shuffle", 1, 1)) == 0.0
    for env in ("", "1e-5,4e-11", "2e-6, 1e-10, 512"):
        assert pm.hockney_from_env(env) == (
            None if rpm.hockney_from_env(env) is None else
            pm.Hockney(**vars(rpm.hockney_from_env(env))))
