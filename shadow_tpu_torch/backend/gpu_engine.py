"""Lane engine driver: config -> lane tables and state -> run -> SimResult.

The counterpart of the JAX package's ``TpuEngine`` for its lane path (tgen,
phold, ping, lane-TCP streams, untiered or on the tiered stream pass;
loss, bootstrap, dynamic runahead; pcap capture and the netobs plane;
fault schedules): it builds the same tables and initial state from a
config (same host ordering, routing, runahead, bucket parameters, loss
thresholds, flow tables and int32 guards), runs the window loop with the
lane kernels on one device — a faulted run segment by segment, each
fault epoch's tables uploaded between segments — and reads the result
back into a :class:`SimResult` that
compares directly with the reference's — with pcap, the capture files of
``<data_directory>/hosts/<name>/eth0.pcap`` byte for byte, with netobs,
``netobs_snapshot()`` counter for counter, and with flowtrace,
``flowtrace_snapshot()`` event for event.
"""

from __future__ import annotations

import dataclasses
import time as wall_time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import default_device
from ..config.options import ConfigOptions, LaneCompatError
from ..core import time as stime
from ..faults import BackendStallError
from ..faults.overlay import build_overlay
from ..models.base import builtin_models, create_model
from ..models.phold import Phold
from ..models.tcpflow import StreamClient, StreamServer
from ..models.tgen import Ping, TgenClient, TgenMesh, TgenServer
from ..net import codel as codel_mod
from ..net import ltcp
from ..net.token_bucket import bucket_params
from ..obs import flowtrace as ftr
from ..obs import netobs as nom
from ..utils.pcap import PcapWriter
from . import bridge, lanes
from . import lanes_stream as lstr
from .results import DELIVERED, PCAP_TX, LogRecord, SimResult
from .setup import build_world

NEVER = stime.NEVER
_I32MAX = (1 << 31) - 1
# the models with a lane law (kernel A): the lane engine runs these
_LANE_MODELS = frozenset({"tgen-mesh", "tgen-client", "tgen-server", "phold",
                          "ping", "stream-client", "stream-server"})


def _event_rows(rows, n_rows: int, width: int, t, kind, src, seq, size):
    """Initial events into ``[n_rows, width]`` queue rows (``rows``: each
    event's row), each row sorted by the 4-word key: the int32 words
    ``(t_hi, t_lo, aux_hi, aux_lo, size)``."""
    q_time = np.full((n_rows, width), NEVER, dtype=np.int64)
    q_auxh = np.zeros((n_rows, width), dtype=np.int32)
    q_auxl = np.zeros((n_rows, width), dtype=np.int32)
    q_size = np.zeros((n_rows, width), dtype=np.int32)
    if rows.size:
        # slot each event into its per-row cumcount position
        order = np.argsort(rows, kind="stable")
        r = rows[order]
        counts = np.bincount(r, minlength=n_rows)
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        pos = np.arange(r.size) - np.repeat(starts, counts)
        q_time[r, pos] = t[order]
        q_auxh[r, pos] = ((kind[order] << lanes.AUX_KIND_SHIFT)
                          | (src[order] << lanes.AUX_SRC_SHIFT))
        q_auxl[r, pos] = seq[order]
        q_size[r, pos] = size[order]
    # rows sorted by the 4-word key (np.lexsort: primary key last)
    order = np.lexsort((q_auxl, q_auxh, q_time), axis=1)
    q_time, q_auxh, q_auxl, q_size = (np.take_along_axis(a, order, axis=1)
                                      for a in (q_time, q_auxh, q_auxl,
                                                q_size))
    never = q_time == NEVER
    q_thi = np.where(never, lanes.NEVER32, q_time >> 31).astype(np.int32)
    q_tlo = np.where(never, lanes.NEVER32,
                     q_time & lanes.MASK31).astype(np.int32)
    return q_thi, q_tlo, q_auxh, q_auxl, q_size


class GpuEngine:
    """``strict_capacity`` (default) raises at collect when any event was
    shed on queue or cross-block overflow: the reference never drops, so a
    run that shed events is not comparable with it."""

    def __init__(
        self,
        cfg: ConfigOptions,
        log_capacity: Optional[int] = None,
        strict_capacity: bool = True,
        device=None,
        external=None,
        world=None,
    ) -> None:
        """``external``: an optional [N] bool mask of EXTERNAL hosts (the
        hybrid backend, ``backend/hybrid.py``): their apps run on the host
        CPU, and their lanes keep only the network's down side (down
        bucket, CoDel, arrival queue), exchanging traffic with the host
        through injection blocks and the egress buffer.  ``world``: a
        prebuilt ``setup.build_world`` tuple (the hybrid engine passes its
        own, so the topology is built once)."""
        self.device = default_device(device)
        cfg.validate()
        self.cfg = cfg
        self.strict_capacity = strict_capacity
        n = len(cfg.hosts)
        ext_mask = (np.zeros(n, dtype=bool) if external is None
                    else np.asarray(external, dtype=bool))
        self._external = ext_mask
        graph, self.ips, self.dns, self.routing, bw_up, bw_dn, runahead = (
            world if world is not None else build_world(cfg))
        # fault schedule: versioned latency and loss tables, uploaded at the
        # epoch boundaries; the run is segmented there, so no window
        # straddles a fault (the reference's tpu_engine.py:262-289)
        self._fault_overlay = (build_overlay(cfg, graph, self.routing)
                               if cfg.faults.events else None)
        ov = self._fault_overlay
        # the netobs and flowtrace snapshots of the last collected run
        self._netobs_data = None
        self._flowtrace_data = None

        # --- per-lane model tables and initial events ---------------------
        model = np.zeros(n, dtype=np.int32)
        p_size = np.zeros(n, dtype=np.int32)
        p_interval = np.ones(n, dtype=np.int64)
        p_peer = np.zeros(n, dtype=np.int32)
        p_count = np.zeros(n, dtype=np.int64)
        p_stride = np.ones(n, dtype=np.int64)
        recv_mult = np.zeros(n, dtype=np.int32)
        local_seq0 = np.ones(n, dtype=np.int64)
        st_segs = np.zeros(n, dtype=np.int32)  # stream-client flow shapes
        st_last = np.zeros(n, dtype=np.int32)
        st_mss = np.zeros(n, dtype=np.int32)
        st_cc = np.zeros(n, dtype=np.int32)
        init_events: list[tuple[int, int, int, int, int, int]] = []  # lane,t,kind,src,seq,size

        def assign_tgen(hid: int, a) -> None:
            if isinstance(a, TgenMesh):
                model[hid] = lanes.M_TGEN_MESH
                p_size[hid] = a.size
                p_interval[hid] = a.interval
                p_stride[hid] = a.stride
            elif isinstance(a, TgenClient):
                model[hid] = lanes.M_TGEN_CLIENT
                p_size[hid] = a.size
                p_interval[hid] = a.interval
                p_peer[hid] = self.dns.resolve(a.server)
            else:
                model[hid] = lanes.M_TGEN_SERVER

        models = builtin_models()
        for hid, hopt in enumerate(cfg.hosts):
            if ext_mask[hid] or not hopt.processes:
                # M_NONE: receives, counts nothing; an external host's apps
                # run on the host side, its lane only receives
                continue
            for p in hopt.processes:
                if p.path not in models:
                    raise LaneCompatError(
                        f"host {hopt.hostname!r}: process {p.path!r} is a "
                        "managed binary; run the config on the hybrid engine "
                        "(backend.hybrid.HybridEngine)")
                if p.path not in _LANE_MODELS:
                    raise LaneCompatError(
                        f"host {hopt.hostname!r}: model {p.path!r} has no "
                        "lane law in the port yet (use the shadow_tpu "
                        "package)")
            apps = [(p, create_model(p.path, list(p.args)))
                    for p in hopt.processes]
            for _p, a in apps:
                if hasattr(a, "set_congestion"):
                    a.set_congestion(hopt.congestion)
            if len(apps) > 1:
                # multi-process tgen hosts: at most one timer-driving
                # process; the others contribute start anchors and delivery
                # counting (recv_mult), as in the reference
                trio = (TgenMesh, TgenClient, TgenServer)
                if not all(isinstance(a, trio) for _p, a in apps):
                    raise LaneCompatError(
                        f"host {hopt.hostname!r}: multi-process lane "
                        "hosts support tgen mesh/client/server "
                        "combinations only (use the shadow_tpu package's "
                        "cpu backend)"
                    )
                drivers = [(p, a) for p, a in apps
                           if isinstance(a, (TgenMesh, TgenClient))]
                if len(drivers) > 1:
                    raise LaneCompatError(
                        f"host {hopt.hostname!r}: at most one "
                        "timer-driving process per lane host"
                    )
                recv_mult[hid] = len(apps)
                driver = drivers[0] if drivers else apps[0]
                for seq, (p, a) in enumerate(apps):
                    init_events.append((
                        hid, p.start_time, lanes.LOCAL, hid, seq,
                        -1 if a is driver[1] else lanes.SZ_ANCHOR,
                    ))
                local_seq0[hid] = len(apps)
                assign_tgen(hid, driver[1])
                continue
            recv_mult[hid] = 1
            proc, app = apps[0]
            t0 = proc.start_time
            if isinstance(app, Phold):
                # the initial messages are size-0 LOCAL events: timers
                # whose pop sends
                model[hid] = lanes.M_PHOLD
                p_size[hid] = app.size
                for i in range(app.messages):
                    init_events.append((hid, t0, lanes.LOCAL, hid, i, 0))
                local_seq0[hid] = max(app.messages, 1)
            elif isinstance(app, Ping):
                if app.peer is None:
                    model[hid] = lanes.M_PING_SERVER
                else:
                    model[hid] = lanes.M_PING_CLIENT
                    p_peer[hid] = self.dns.resolve(app.peer)
                    p_count[hid] = app.count_target
                    p_interval[hid] = app.interval
                p_size[hid] = app.size
                init_events.append((hid, t0, lanes.LOCAL, hid, 0, -1))
            elif isinstance(app, StreamClient):
                model[hid] = lanes.M_STREAM_CLIENT
                p_peer[hid] = self.dns.resolve(app.server)
                # magnitude guards: seq units ride a 26-bit payload field
                # and rx_bytes an int32 counter
                if app.fs.segs + 2 >= (1 << lstr.PAY_SEQ_BITS):
                    raise LaneCompatError(
                        f"stream flow of {app.fs.segs} segments exceeds the "
                        f"lane backend's {lstr.PAY_SEQ_BITS}-bit sequence "
                        "space (use the shadow_tpu package's cpu backend)"
                    )
                if app.size >= (1 << 31):
                    raise LaneCompatError(
                        "stream transfer size exceeds the lane backend's "
                        "int32 byte counter (use the shadow_tpu package's "
                        "cpu backend)"
                    )
                st_segs[hid], st_last[hid] = app.fs.segs, app.fs.last_bytes
                st_mss[hid], st_cc[hid] = app.mss, app.fs.cc
                init_events.append((hid, t0, lanes.LOCAL, hid, 0, -1))
            elif isinstance(app, StreamServer):
                model[hid] = lanes.M_STREAM_SERVER
                # the start marker anchors windows like the CPU engine's
                # start task (flows open on the first SYN)
                init_events.append((hid, t0, lanes.LOCAL, hid, 0, -1))
            else:
                assert isinstance(app, (TgenMesh, TgenClient, TgenServer))
                assign_tgen(hid, app)
                init_events.append((hid, t0, lanes.LOCAL, hid, 0, -1))
        ev = np.asarray(init_events, dtype=np.int64).reshape(-1, 6)
        self._init_cols = tuple(ev[:, j] for j in range(6))
        self._local_seq0 = local_seq0

        capacity = cfg.experimental.tpu_lane_queue_capacity
        if cfg.experimental.tpu_cross_capacity < 0:
            raise LaneCompatError(
                f"tpu_cross_capacity={cfg.experimental.tpu_cross_capacity} "
                "must be >= 0 (0 = queue capacity)"
            )
        ev_lane = self._init_cols[0]
        max_init = (
            int(np.bincount(ev_lane, minlength=max(n, 1)).max())
            if ev_lane.size else 0
        )
        if capacity < max_init + 8:
            raise LaneCompatError(
                f"tpu_lane_queue_capacity={capacity} too small for {max_init} "
                "initial events per lane (+8 headroom)"
            )

        node_idx, lat, thresh = self.routing.device_tables()
        if log_capacity is None:
            log_capacity = 200_000

        # stream pairing: one-to-one when every stream server is the peer of
        # exactly one client (the split exchange), else the star (combined)
        client_ids = np.nonzero(model == lanes.M_STREAM_CLIENT)[0]
        server_ids = set(np.nonzero(model == lanes.M_STREAM_SERVER)[0].tolist())
        peer_counts: dict[int, int] = {}
        for cid in client_ids:
            peer_counts[int(p_peer[cid])] = peer_counts.get(int(p_peer[cid]), 0) + 1
        if server_ids and not client_ids.size:
            # the reference sizes its flow tables by the clients: with
            # none, its [2] placeholders would read as flows
            raise LaneCompatError(
                "stream-server hosts without any stream-client are not "
                "supported on the lane backend (use the shadow_tpu "
                "package's cpu backend)"
            )
        one_to_one = bool(client_ids.size) and all(
            peer_counts.get(sid, 0) == 1 for sid in server_ids
        ) and all(pid in server_ids for pid in peer_counts)
        # the tiered stream backend: one-to-one flows move to their own
        # [2S]-row tier (the reference's decision; it also needs no
        # external lanes, which the port does not run).  Flowtrace rides
        # the untiered path: a traced run drops the tier, an equivalent
        # execution with the same events
        flowtrace = bool(cfg.experimental.flowtrace)
        # a hybrid run keeps the untiered path too: host injections land in
        # [N] rows, which the tier would orphan for stream lanes
        tiered = (one_to_one and bool(cfg.experimental.tpu_stream_tiered)
                  and not flowtrace and not ext_mask.any())
        # wide stream co-pop is sound only when every possible window ends
        # before RTO_MIN (a DELIVERY pop then inserts nothing same-window);
        # the dynamic window never exceeds the largest link latency
        max_lat = int(np.max(np.asarray(lat), initial=0))
        if ov is not None:
            # fault epochs can raise latencies mid-run: the bound must hold
            # for every epoch's tables
            max_lat = max(max_lat, ov.max_latency_ns())
        stream_wide_pop = max(runahead, max_lat) < ltcp.RTO_MIN
        # pcap rides the device log: a capturing host's sends become
        # PCAP_TX records, its deliveries are the DELIVERED records
        lane_pcap = np.array([h.pcap_enabled for h in cfg.hosts], dtype=bool)
        # external hosts' captures are written host-side (the host knows the
        # payload bytes); the device captures lane-model hosts only
        lane_pcap = lane_pcap & ~ext_mask
        pcap_any = bool(lane_pcap.any())
        if pcap_any and log_capacity == 0:
            raise LaneCompatError(
                "pcap capture on the lane backend rides the device event "
                "log; log_capacity=0 disables it — enable logging"
            )
        ends = np.concatenate([client_ids, p_peer[client_ids]]).astype(np.int64)
        flow_thresh, flow_all = ftr.sample_thresh(
            cfg.experimental.flowtrace_sample)

        self.params = lanes.LaneParams(
            n_lanes=n,
            capacity=capacity,
            pops_per_iter=cfg.experimental.tpu_events_per_round,
            log_capacity=log_capacity,
            stop_time=cfg.general.stop_time,
            runahead=runahead,
            seed=cfg.general.seed,
            bootstrap_end=cfg.general.bootstrap_end_time,
            models_present=tuple(int(x) for x in np.unique(model)),
            # a fault epoch may bring loss later in the run: the draw runs
            # from the start (it keys on the send sequence, so drawing on
            # loss-free segments shifts nothing)
            has_loss=(bool(np.any(np.asarray(thresh) > 0))
                      or (ov is not None and ov.any_loss())),
            dynamic_runahead=bool(cfg.experimental.use_dynamic_runahead),
            runahead_floor=max(cfg.experimental.runahead or 0, 1),
            cross_capacity=cfg.experimental.tpu_cross_capacity,
            stream_one_to_one=one_to_one,
            stream_clients=tuple(int(c) for c in client_ids),
            stream_wide_pop=stream_wide_pop,
            stream_tiered=tiered,
            stream_pops=cfg.experimental.tpu_stream_events_per_round,
            stream_capacity=cfg.experimental.tpu_stream_queue_capacity,
            pcap_any=pcap_any,
            stream_pcap=bool(lane_pcap[ends].any()),
            netobs=bool(cfg.experimental.netobs),
            flowtrace=flowtrace,
            flow_capacity=(cfg.experimental.flowtrace_capacity
                           if flowtrace else 0),
            flow_thresh=flow_thresh,
            flow_all=flow_all,
            flow_seed=cfg.general.seed,
            external_any=bool(ext_mask.any()),
            # worst case: every external lane pops a full slot row of
            # packets in one iteration; a turn stops while the egress buffer
            # still has that much room, so it never overflows
            ext_per_iter=(int(ext_mask.sum())
                          * cfg.experimental.tpu_events_per_round),
            egress_capacity=(max(1024, 4 * int(ext_mask.sum())
                                 * cfg.experimental.tpu_events_per_round)
                             if ext_mask.any() else 0),
            inject_batch=(cfg.experimental.tpu_inject_batch
                          if ext_mask.any() else 0),
            inject_cross=capacity if ext_mask.any() else 0,
        )

        up = np.array([bucket_params(int(b)) for b in bw_up], dtype=np.int64)
        dn = np.array([bucket_params(int(b)) for b in bw_dn], dtype=np.int64)

        # int32 magnitude guards (the reference's): the lane arithmetic is
        # exact only within these ranges — refuse configs beyond them
        interval = self.params.bucket_interval

        def _check(name, arr, limit):
            mx = int(np.max(arr)) if np.size(arr) else 0
            if mx > limit:
                raise LaneCompatError(
                    f"{name} {mx} exceeds the lane backend's int32 range "
                    f"({limit})"
                )

        if interval >= lanes.MOD_SMALL_LIMIT:
            raise LaneCompatError(
                f"bucket interval {interval} ns exceeds the chunked-mod "
                f"ceiling ({lanes.MOD_SMALL_LIMIT})"
            )
        # strictly below NEVER32: a latency equal to the sentinel would read
        # as "no sends yet" in the dynamic-runahead scalar
        _check("link latency (ns)", np.asarray(lat), _I32MAX - 1)
        if ov is not None:
            _check("fault-epoch link latency (ns)",
                   np.asarray([ov.max_latency_ns()]), _I32MAX - 1)
        _check("runahead (ns)", np.asarray([runahead]), _I32MAX)
        for side, b in (("up", up), ("dn", dn)):
            # the refill computes tokens + k*rate <= 2*burst + rate before
            # clamping to burst: that intermediate must fit int32
            _check(f"{side} bucket refill ceiling (2*burst + rate)",
                   2 * b[:, 1] + b[:, 0], _I32MAX)
        _check("datagram size", p_size, 1 << 20)
        # one max-size packet's bucket wait must fit the int32 horizon
        max_bits = (int(np.max(p_size, initial=0)) + 65536 + 38) * 8
        for side, b in (("up", up), ("dn", dn)):
            rates = b[:, 0][b[:, 0] > 0]
            if rates.size:
                w_max = -(-max_bits // int(rates.min()))
                if w_max * interval > _I32MAX:
                    raise LaneCompatError(
                        f"{side} bandwidth {int(rates.min())} bits/interval "
                        "is too low for the lane backend's int32 wait horizon "
                        "(one packet would wait > 2.1 s for tokens)"
                    )

        def _kfull(b):
            rate = np.maximum(b[:, 0], 1)
            kf = b[:, 1] // rate + 1
            kfi = kf * interval
            _check("bucket full-refill horizon (ns)", kfi, _I32MAX)
            return kf, kfi

        up_kfull, up_kfi = _kfull(up)
        dn_kfull, dn_kfi = _kfull(dn)

        def t32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int32),
                                   device=self.device)

        # stream flows on [2S] endpoint rows (clients, then their servers,
        # flow order = ascending client lane), everything static per flow
        # precomputed; [2] placeholders when no stream model is present
        s_flows = int(client_ids.size)
        if s_flows:
            fcl = client_ids.astype(np.int64)
            fsv = p_peer[fcl].astype(np.int64)
            el = np.concatenate([fcl, fsv])
            peer = np.concatenate([fsv, fcl])
            e_nodes, p_nodes = np.asarray(node_idx)[el], np.asarray(node_idx)[peer]
            flow_lat = np.asarray(lat)[e_nodes, p_nodes]
            flow_thr = np.asarray(thresh)[e_nodes, p_nodes]
            zs = np.zeros(s_flows, dtype=np.int32)
            # CC follows the data sender; receiver rows stay CC_RENO
            flow_shape = [np.concatenate([a[fcl], zs])
                          for a in (st_segs, st_mss, st_last, st_cc)]
            flow_clid = np.concatenate([fcl, fcl])
        else:
            el = peer = flow_clid = np.zeros(2, dtype=np.int64)
            e_nodes = p_nodes = el
            flow_lat = np.zeros(2, dtype=np.int64)
            flow_thr = np.zeros(2, dtype=np.int64)
            flow_shape = [np.zeros(2, dtype=np.int32)] * 4
        # lane -> endpoint rows, for kernel A's thread per lane
        ep_start, ep_rows = bridge.lane_endpoints(el, n, s_flows)
        # tiered: the endpoint lanes' down buckets, and which lanes are
        # endpoints (empty otherwise, where the reference holds ())
        el_t = el if tiered else np.zeros(0, dtype=np.int64)
        lane_stream = np.isin(np.arange(n), el_t) if tiered else np.zeros(
            0, dtype=bool)

        self.tables = lanes.LaneTables(
            node_of=t32(node_idx), lat=t32(lat),
            thresh=torch.as_tensor(np.asarray(thresh, dtype=np.int64),
                                   device=self.device),
            up_rate=t32(up[:, 0]), up_burst=t32(up[:, 1]),
            up_kfull=t32(up_kfull), up_kfi=t32(up_kfi),
            dn_rate=t32(dn[:, 0]), dn_burst=t32(dn[:, 1]),
            dn_kfull=t32(dn_kfull), dn_kfi=t32(dn_kfi),
            model=t32(model), recv_mult=t32(recv_mult), p_size=t32(p_size),
            p_int_hi=t32(p_interval >> 31), p_int_lo=t32(p_interval & lanes.MASK31),
            p_peer=t32(p_peer), p_count=t32(np.minimum(p_count, _I32MAX)),
            p_stride=t32(p_stride),
            codel_div=t32(codel_mod.CODEL_DIV),
            flow_lanes=t32(el), flow_peers=t32(peer), flow_clid=t32(flow_clid),
            flow_lat=t32(flow_lat),
            flow_thresh=torch.as_tensor(flow_thr.astype(np.int64),
                                        device=self.device),
            flow_segs=t32(flow_shape[0]), flow_mss=t32(flow_shape[1]),
            flow_last=t32(flow_shape[2]), flow_cc=t32(flow_shape[3]),
            flow_up_rate=t32(up[el, 0]), flow_up_burst=t32(up[el, 1]),
            flow_up_kfull=t32(up_kfull[el]), flow_up_kfi=t32(up_kfi[el]),
            flow_dn_rate=t32(dn[el_t, 0]), flow_dn_burst=t32(dn[el_t, 1]),
            flow_dn_kfull=t32(dn_kfull[el_t]), flow_dn_kfi=t32(dn_kfi[el_t]),
            lane_stream=torch.as_tensor(lane_stream, device=self.device),
            lane_ep_start=t32(ep_start), lane_ep_rows=t32(ep_rows),
            lane_pcap=torch.as_tensor(lane_pcap, device=self.device),
            flow_pcap=torch.as_tensor(lane_pcap[el], device=self.device),
            lane_external=(torch.as_tensor(ext_mask, device=self.device)
                           if ext_mask.any() else t32(np.zeros(0))),
        )
        self._up_burst = up[:, 1]
        self._dn_burst = dn[:, 1]
        self._el = el  # [2S] endpoint lanes (tiered: their tier rows)
        # the graph nodes of each endpoint and of its peer: where a fault
        # epoch's tables are gathered into the [2S] flow tables
        self._flow_nodes = (e_nodes, p_nodes)

    # -- state construction ------------------------------------------------

    def initial_state(self) -> lanes.LaneState:
        p = self.params
        n, c = p.n_lanes, p.capacity
        cols = self._init_cols
        if p.stream_tiered:
            # the stream endpoints' events go to their tier rows
            on_tier = np.isin(cols[0], self._el)
            t_cols = [a[on_tier] for a in cols]
            cols = [a[~on_tier] for a in cols]
        q_thi, q_tlo, q_auxh, q_auxl, q_size = _event_rows(cols[0], n, c,
                                                           *cols[1:])
        dev = self.device

        def t32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)

        def zeros():
            return torch.zeros(n, dtype=torch.int32, device=dev)

        def scalar(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        def pay():  # payload words only where stream events ride the queues
            shape = (n, c) if p.lane.stream_present else (0,)
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        def nb(*shape):  # the netobs block, empty when it is off
            return torch.zeros(shape if p.netobs else (0,),
                               dtype=torch.int32, device=dev)

        def fl(*shape):  # the flowtrace ring, empty when it is off
            return torch.zeros(shape if p.flowtrace else (0,),
                               dtype=torch.int32, device=dev)

        def eg(v=None):  # the egress scalars, empty off the hybrid backend
            if p.external_any and v is not None:
                return scalar(v)
            return torch.zeros(0, dtype=torch.int32, device=dev)

        if p.stream_tiered:
            stream = self._initial_tier(t_cols)
        elif p.stream_present:
            stream = lstr.init_stream_state(p.s_flows, dev)
        else:
            stream = torch.zeros(0, dtype=torch.int32, device=dev)

        # bucket state: next_refill one interval in (grid-aligned),
        # last_depart 0; CoDel first_above at the UNSET sentinel
        return lanes.LaneState(
            q_thi=t32(q_thi), q_tlo=t32(q_tlo), q_auxh=t32(q_auxh),
            q_auxl=t32(q_auxl), q_size=t32(q_size),
            q_phi=pay(), q_plo=pay(),
            send_seq=zeros(), local_seq=t32(self._local_seq0),
            app_draws=zeros(),
            up_tokens=t32(self._up_burst), up_nr_hi=zeros(),
            up_nr_lo=t32(np.full(n, p.bucket_interval)),
            up_ld_hi=zeros(), up_ld_lo=zeros(),
            dn_tokens=t32(self._dn_burst), dn_nr_hi=zeros(),
            dn_nr_lo=t32(np.full(n, p.bucket_interval)),
            dn_ld_hi=zeros(), dn_ld_lo=zeros(),
            cd_fat_hi=t32(np.full(n, lanes.CD_UNSET)), cd_fat_lo=zeros(),
            cd_dnext_hi=zeros(), cd_dnext_lo=zeros(), cd_drop_count=zeros(),
            cd_dropping=torch.zeros(n, dtype=torch.bool, device=dev),
            m_sent=zeros(), m_peer_offset=zeros(),
            n_delivered=zeros(), n_loss=zeros(), n_codel=zeros(),
            n_queue=zeros(), recv_bytes=zeros(), n_sends=zeros(),
            n_hops=zeros(),
            log=torch.zeros((max(p.log_capacity, 1), 6), dtype=torch.int64,
                            device=dev),
            log_count=scalar(0), log_lost=scalar(0),
            stream=stream,
            rounds=scalar(0), iters=scalar(0),
            now_we_hi=scalar(0), now_we_lo=scalar(0),
            min_used_lat=scalar(lanes.NEVER32),
            nb_txb=nb(n), nb_rxb=nb(n), nb_thr=nb(n), nb_shed=nb(n),
            nb_hist=nb(lanes.NB_HIST_BUCKETS), nb_win=nb(),
            fl_buf=fl(p.flow_capacity, ftr.FT_COLS), fl_count=fl(),
            fl_lost=fl(),
            egress=(torch.zeros((p.egress_capacity, 6), dtype=torch.int64,
                                device=dev)
                    if p.external_any else eg()),
            egress_count=eg(0), egress_lost=eg(0),
            egress_min_hi=eg(lanes.NEVER32), egress_min_lo=eg(lanes.NEVER32),
        )

    def _initial_tier(self, cols) -> lstr.TierState:
        """The tier's start state: each endpoint's events (``cols``, the
        initial-event columns of endpoint lanes) in its row, rows sorted by
        the key; the endpoint lanes' bucket bursts; the local sequence
        counters of the lanes."""
        p, dev = self.params, self.device
        el = self._el
        row_of = {int(x): r for r, x in enumerate(el)}
        rows = np.array([row_of[int(x)] for x in cols[0]], dtype=np.int64)
        words = _event_rows(rows, 2 * p.s_flows, p.stream_capacity, *cols[1:])
        tier = lstr.init_tier_state(
            p.s_flows, p.stream_capacity, dn_tokens=self._dn_burst[el],
            up_tokens=self._up_burst[el], interval=p.bucket_interval,
            device=dev)
        tier.q[:5] = torch.from_numpy(np.stack(words))
        tier.v[lstr.TV_LOCAL_SEQ] = torch.as_tensor(
            self._local_seq0[el].astype(np.int32), device=dev)
        return tier

    def first_event_time(self) -> int:
        """The earliest initial event's time (NEVER when none): the hybrid
        window loop's first device bound."""
        t = self._init_cols[1]
        return int(t.min()) if t.size else NEVER

    def make_hybrid_fns(self, state: lanes.LaneState):
        """The hybrid backend's device entry point, bound to ``state``
        (updated in place) and this engine's tables: the
        ``lanes._build_hybrid_run`` turn function.  Kernel H runs inside it,
        once per staged block: there is no standalone injection entry."""
        if not self.params.external_any:
            raise ValueError("make_hybrid_fns needs external lanes")
        return lanes._build_hybrid_run(self.params, self.tables, state)

    def current_runahead(self) -> int:
        """The live window width: the static runahead, or with dynamic
        runahead the smallest latency sent over so far in the last run
        (never below the floor)."""
        p = self.params
        state = getattr(self, "_live_state", None)
        if not p.dynamic_runahead or state is None:
            return p.runahead
        used = int(state.min_used_lat)
        if used >= lanes.NEVER32:
            return p.runahead
        return max(used, max(p.runahead_floor, 1))

    # -- running -----------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- fault-epoch segmentation ------------------------------------------

    def segment_tables(self, snap=None) -> lanes.LaneTables:
        """The tables of a fault epoch (the reference's
        ``_segment_tables``): the ``[G, G]`` latency and loss tables of the
        snapshot ``snap`` and, with stream flows, the ``[2S]`` flow tables
        gathered from them (the tier reads those too); the run's own tables
        when ``snap`` is None.  Loss stays one int64 threshold in the u64
        domain: a snapshot's thresholds lie in [0, 2**32], where that is
        ``bridge.thresh_from_split`` of the reference's split pair."""
        if snap is None:
            return self.tables
        dev = self.device
        lat = np.asarray(snap.latency_ns)
        thr = np.asarray(snap.loss_threshold, dtype=np.int64)
        kw = {"lat": torch.as_tensor(lat.astype(np.int32), device=dev),
              "thresh": torch.as_tensor(thr, device=dev)}
        if self.params.s_flows:
            e_nodes, p_nodes = self._flow_nodes
            kw["flow_lat"] = torch.as_tensor(
                lat[e_nodes, p_nodes].astype(np.int32), device=dev)
            kw["flow_thresh"] = torch.as_tensor(thr[e_nodes, p_nodes],
                                                device=dev)
        return self.tables._replace(**kw)

    def segment_plan(self, pad_to: int = 0) -> list:
        """The run's ``(seg_start, seg_end, snapshot)`` rows: one per fault
        epoch inside the run (``FaultOverlay.segment_plan``), one row of
        the whole run without a schedule; padded with zero-length rows at
        the stop time to ``pad_to`` rows."""
        stop = self.params.stop_time
        ov = self._fault_overlay
        if ov is not None:
            return ov.segment_plan(stop, pad_to=pad_to)
        return [(0, stop, None)] + [(stop, stop, None)] * (pad_to - 1)

    def _run_faulted(self, mode: str, state: lanes.LaneState,
                     plan: list) -> None:
        """Run ``state`` to the end segment by segment along ``plan``
        (``segment_plan``; the reference's ``_run_faulted``): each segment
        an ordinary run whose stop time is the next fault epoch, against
        that epoch's tables, so no window straddles a fault; the lane state
        carries across untouched.  A ``backend_stall`` epoch raises
        :class:`BackendStallError`.  In device mode the segments are one
        batched loop of one scenario, re-targeted at each epoch (the
        sweep's own driver)."""
        ov = self._fault_overlay
        if mode == "device":
            run_fn = lanes._build_sweep_run([self.params], [self.tables],
                                            [state])
        for seg_start, seg_end, snap in plan:
            if 0 < seg_start < seg_end and ov.stall_at(seg_start):
                raise BackendStallError(
                    f"injected backend stall at {seg_start} ns "
                    "(fault schedule backend_stall event)")
            tb = self.segment_tables(snap)
            if mode == "device":
                run_fn([tb], [seg_end])
            else:
                p = dataclasses.replace(self.params, stop_time=seg_end)
                round_fn = lanes._build_round(p, tb, state)
                while not round_fn():
                    pass

    def run(self, mode: str = "device") -> SimResult:
        """``mode='device'``: the device loop, which reads the device's
        ``live`` flag every few steps; ``mode='step'``: one window per
        round, reading the flags after every iteration.  With a fault
        schedule, either runs segment by segment (``_run_faulted``)."""
        if mode not in ("device", "step"):
            raise ValueError(f"mode must be 'device' or 'step', got {mode!r}")
        state = self.initial_state()
        self._live_state = state
        p, tb = self.params, self.tables
        if self._fault_overlay is not None:
            def run_fn() -> None:
                self._run_faulted(mode, state, self.segment_plan())
        elif mode == "device":
            run_fn = lanes._build_full_run(p, tb, state)
        else:
            round_fn = lanes._build_round(p, tb, state)

            def run_fn() -> None:
                while not round_fn():
                    pass

        self._sync()
        t0 = wall_time.perf_counter()
        run_fn()
        self._sync()
        wall = wall_time.perf_counter() - t0
        return self.collect(state, wall)

    def collect(self, s: lanes.LaneState, wall: float) -> SimResult:
        # every per-lane counter is monotone, so an int32 wrap shows as a
        # negative value: raise instead of reporting garbage
        wrap_check = ["send_seq", "local_seq", "app_draws", "n_delivered",
                      "n_sends", "n_hops", "recv_bytes", "m_peer_offset"]
        if self.params.netobs:
            wrap_check += ["nb_txb", "nb_rxb", "nb_thr"]
        if self.params.flowtrace:
            wrap_check += ["fl_count", "fl_lost"]
        for fname in wrap_check:
            if int(getattr(s, fname).min()) < 0:
                raise RuntimeError(
                    f"lane counter {fname} wrapped past 2**31; this run "
                    "exceeds the lane backend's int32 counter range"
                )
        # tiered: the tier owns the stream endpoints' network accounting;
        # its compact counters fold into the lane totals
        tv = s.stream.v if self.params.stream_tiered else None
        if tv is not None and int(tv[lstr.TV_SEND_SEQ].min()) < 0:
            raise RuntimeError(
                "tier counter send_seq wrapped past 2**31; this run "
                "exceeds the lane backend's int32 counter range"
            )

        def tier_sum(row: int) -> int:
            return int(tv[row].sum()) if tv is not None else 0

        n_queue_drops = int(s.n_queue.sum()) + tier_sum(lstr.TV_N_QUEUE)
        if n_queue_drops and self.strict_capacity:
            raise RuntimeError(
                f"{n_queue_drops} events dropped on lane-queue overflow; raise "
                "experimental.tpu_lane_queue_capacity (results would silently "
                "diverge from the reference)"
            )
        log_lost = int(s.log_lost)
        if log_lost:
            raise RuntimeError(
                f"device event log overflowed ({log_lost} records lost); "
                "raise log_capacity or disable logging"
            )
        log_count = min(int(s.log_count), self.params.log_capacity)
        rows = s.log[:log_count].cpu().numpy()
        if self.params.pcap_any:
            pcap_rows = rows[rows[:, 5] == PCAP_TX]
            rows = rows[rows[:, 5] != PCAP_TX]
            self._write_pcaps(rows, pcap_rows)
        event_log = [LogRecord(*row) for row in rows.tolist()]
        model = self.tables.model
        tgen = ((model == lanes.M_TGEN_MESH) | (model == lanes.M_TGEN_CLIENT)
                | (model == lanes.M_TGEN_SERVER))
        counters: dict[str, int] = {}

        def add(key: str, val: int) -> None:
            if val:
                counters[key] = counters.get(key, 0) + int(val)

        add("tgen_recv_bytes", int(s.recv_bytes[tgen].sum()))
        add("phold_hops", int(s.n_hops[model == lanes.M_PHOLD].sum()))
        add("lane_iters", int(s.iters))
        add("lane_delivered", int(s.n_delivered.sum())
            + tier_sum(lstr.TV_N_DEL))
        add("lane_drop_loss", int(s.n_loss.sum()) + tier_sum(lstr.TV_N_LOSS))
        add("lane_drop_codel", int(s.n_codel.sum())
            + tier_sum(lstr.TV_N_CODEL))
        add("lane_drop_queue", n_queue_drops)
        add("lane_sends", int(s.n_sends.sum()) + tier_sum(lstr.TV_N_SENDS))
        if self.params.stream_present:
            flows = s.stream.flows if tv is not None else s.stream
            cl_m, sv_m = flows[0], flows[1]
            done = cl_m[:, lstr.C_COMPLETED] != 0
            if bool(done.any()):
                # totals at completion, like the CPU oracle (zero-valued
                # keys included: counter-set parity)
                counters["stream_complete"] = int(done.sum())
                counters["stream_tx_segs"] = int(cl_m[done, lstr.C_TX_SEGS].sum())
                counters["stream_retransmits"] = int(
                    cl_m[done, lstr.C_RETRANS].sum())
            add("stream_rx_bytes", int(sv_m[:, lstr.C_RX_BYTES].sum()))
            add("stream_rx_segs", int(sv_m[:, lstr.C_RX_SEGS].sum()))
            add("stream_flows_done", int((sv_m[:, lstr.C_COMPLETED] != 0).sum()))
        if self.params.netobs:
            self._netobs_data = self._netobs_collect(s)
        if self.params.flowtrace:
            self._flowtrace_data = self._flowtrace_collect(s)
        return SimResult(
            sim_time_ns=self.params.stop_time,
            wall_seconds=wall,
            rounds=int(s.rounds),
            event_log=event_log,
            counters=counters,
        )

    def _write_pcaps(self, event_rows: np.ndarray,
                     pcap_rows: np.ndarray) -> None:
        """The capture files of the capturing hosts, from the device log:
        outbound = the PCAP_TX records (at bucket departure), inbound = the
        DELIVERED records (at delivery) — the reference's two capture
        points, written in ``(time, direction, src, dst, seq)`` order, so
        the files are byte-identical to its own."""
        # one sort per array, then each host's rows as a slice
        out_sorted = pcap_rows[np.argsort(pcap_rows[:, 1], kind="stable")]
        delivered = event_rows[event_rows[:, 5] == DELIVERED]
        in_sorted = delivered[np.argsort(delivered[:, 2], kind="stable")]
        root = Path(self.cfg.general.data_directory) / "hosts"
        for hid, hopt in enumerate(self.cfg.hosts):
            if not hopt.pcap_enabled or self._external[hid]:
                # external (hybrid) hosts' files are written host-side
                continue
            w = PcapWriter(root / hopt.hostname / "eth0.pcap",
                           snaplen=hopt.pcap_capture_size)
            for rows, col, dirn in ((out_sorted, 1, 1), (in_sorted, 2, 0)):
                lo, hi = np.searchsorted(rows[:, col], [hid, hid + 1])
                for t, src, dst, seq, size, _o in rows[lo:hi].tolist():
                    w.capture(stime.sim_to_emu(t), self.ips.by_host[src],
                              self.ips.by_host[dst], size,
                              key=(dirn, src, dst, seq))
            w.close()

    def _netobs_collect(self, s: lanes.LaneState) -> dict:
        """The netobs snapshot in ``obs.netobs``'s per-host schema (the
        reference's ``_netobs_collect``): the lanes' counters, with the
        tier's rows added to their endpoint lanes; ``drop_queue`` without
        the cross-block sheds, which count apart; retransmits of completed
        flows at their client lane; and the trailing window, which no
        window advance followed, folded into the histogram here."""
        p = self.params
        tv = s.stream.v.cpu().numpy() if p.stream_tiered else None

        def fold(lane_arr, tv_row=None):
            out = lane_arr.cpu().numpy().astype(np.int64)
            if tv is not None and tv_row is not None:
                np.add.at(out, self._el, tv[tv_row].astype(np.int64))
            return out

        shed = fold(s.nb_shed)
        arrays = {
            "sent": fold(s.n_sends, lstr.TV_N_SENDS),
            "delivered": fold(s.n_delivered, lstr.TV_N_DEL),
            "tx_bytes": fold(s.nb_txb, lstr.TV_NB_TXB),
            "rx_bytes": fold(s.nb_rxb, lstr.TV_NB_RXB),
            "drop_loss": fold(s.n_loss, lstr.TV_N_LOSS),
            "drop_codel": fold(s.n_codel, lstr.TV_N_CODEL),
            "drop_queue": fold(s.n_queue, lstr.TV_N_QUEUE) - shed,
            "drop_cross_shed": shed,
            "throttled": fold(s.nb_thr, lstr.TV_NB_THR),
            "retransmits": np.zeros(p.n_lanes, dtype=np.int64),
            "retry_giveup": np.zeros(p.n_lanes, dtype=np.int64),
        }
        if p.stream_present:
            flows = s.stream.flows if tv is not None else s.stream
            cl_m = flows[0].cpu().numpy()
            done = cl_m[:, lstr.C_COMPLETED] != 0
            np.add.at(arrays["retransmits"],
                      np.asarray(p.stream_clients, dtype=np.int64),
                      np.where(done, cl_m[:, lstr.C_RETRANS], 0).astype(
                          np.int64))
        hist = s.nb_hist.cpu().numpy().astype(np.int64)
        tail = int(s.nb_win)
        if tail > 0:
            hist[nom.hist_bucket(tail)] += 1
        return {"arrays": arrays, "window_hist": hist, "log_lost": 0}

    def _flowtrace_collect(self, s: lanes.LaneState) -> dict:
        """The flowtrace ring decoded (the reference's
        ``_flowtrace_collect``): the kept rows are its prefix, since it
        never wraps; ``ring_lost`` counts the rows past its end."""
        kept = min(int(s.fl_count), self.params.flow_capacity)
        return {"raw": ftr.rows_to_events(s.fl_buf[:kept].cpu().numpy()),
                "ring_lost": int(s.fl_lost)}

    def flowtrace_snapshot(self) -> Optional[dict]:
        """The flowtrace events of the last collected run: ``raw`` (event
        tuples in ring order; ``obs.flowtrace.canonical_events`` sorts
        them) and ``ring_lost``; None when flowtrace is off or no run has
        been collected."""
        return self._flowtrace_data

    def netobs_snapshot(self) -> Optional[dict]:
        """The netobs snapshot of the last collected run: ``arrays`` (the
        per-host counters of ``obs.netobs.COUNTERS``) and ``window_hist``;
        None when netobs is off or no run has been collected."""
        return self._netobs_data
