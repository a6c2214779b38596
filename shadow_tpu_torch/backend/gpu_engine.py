"""Lane engine driver: config -> lane tables and state -> run -> SimResult.

The counterpart of the JAX package's ``TpuEngine`` for the passive lane
path: it builds the same tables and initial state from a config (same host
ordering, routing, runahead, bucket parameters and int32 guards), runs the
window loop with the lane kernels on one device, and reads the result back
into a :class:`SimResult` that compares directly with the reference's.
"""

from __future__ import annotations

import time as wall_time
from typing import Optional

import numpy as np
import torch

from .. import default_device
from ..config.options import ConfigOptions, LaneCompatError
from ..core import time as stime
from ..models.base import create_model
from ..models.tgen import TgenClient, TgenMesh, TgenServer
from ..net import codel as codel_mod
from ..net.token_bucket import bucket_params
from . import lanes
from .results import LogRecord, SimResult
from .setup import build_world

NEVER = stime.NEVER
_I32MAX = (1 << 31) - 1


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
    ) -> None:
        self.device = default_device(device)
        cfg.validate()
        self.cfg = cfg
        self.strict_capacity = strict_capacity
        n = len(cfg.hosts)
        _graph, _ips, self.dns, self.routing, bw_up, bw_dn, runahead = (
            build_world(cfg))

        # --- per-lane model tables and initial events ---------------------
        model = np.zeros(n, dtype=np.int32)
        p_size = np.zeros(n, dtype=np.int32)
        p_interval = np.ones(n, dtype=np.int64)
        p_peer = np.zeros(n, dtype=np.int32)
        p_stride = np.ones(n, dtype=np.int64)
        recv_mult = np.zeros(n, dtype=np.int32)
        local_seq0 = np.ones(n, dtype=np.int64)
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

        for hid, hopt in enumerate(cfg.hosts):
            if not hopt.processes:
                continue  # M_NONE: receives, counts nothing
            apps = [(p, create_model(p.path, list(p.args)))
                    for p in hopt.processes]
            if len(apps) > 1:
                # multi-process tgen hosts: at most one timer-driving
                # process; the others contribute start anchors and delivery
                # counting (recv_mult), as in the reference
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
            assert isinstance(app, (TgenMesh, TgenClient, TgenServer))
            assign_tgen(hid, app)
            init_events.append((hid, proc.start_time, lanes.LOCAL, hid, 0, -1))
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

        node_idx, lat = self.routing.device_tables()
        if log_capacity is None:
            log_capacity = 200_000
        self.params = lanes.LaneParams(
            n_lanes=n,
            capacity=capacity,
            pops_per_iter=cfg.experimental.tpu_events_per_round,
            log_capacity=log_capacity,
            stop_time=cfg.general.stop_time,
            runahead=runahead,
            cross_capacity=cfg.experimental.tpu_cross_capacity,
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
        _check("link latency (ns)", np.asarray(lat), _I32MAX - 1)
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

        self.tables = lanes.LaneTables(
            node_of=t32(node_idx), lat=t32(lat),
            up_rate=t32(up[:, 0]), up_burst=t32(up[:, 1]),
            up_kfull=t32(up_kfull), up_kfi=t32(up_kfi),
            dn_rate=t32(dn[:, 0]), dn_burst=t32(dn[:, 1]),
            dn_kfull=t32(dn_kfull), dn_kfi=t32(dn_kfi),
            model=t32(model), recv_mult=t32(recv_mult), p_size=t32(p_size),
            p_int_hi=t32(p_interval >> 31), p_int_lo=t32(p_interval & lanes.MASK31),
            p_peer=t32(p_peer), p_stride=t32(p_stride),
            codel_div=t32(codel_mod.CODEL_DIV),
        )
        self._up_burst = up[:, 1]
        self._dn_burst = dn[:, 1]

    # -- state construction ------------------------------------------------

    def initial_state(self) -> lanes.LaneState:
        p = self.params
        n, c = p.n_lanes, p.capacity
        q_time = np.full((n, c), NEVER, dtype=np.int64)
        q_auxh = np.zeros((n, c), dtype=np.int32)
        q_auxl = np.zeros((n, c), dtype=np.int32)
        q_size = np.zeros((n, c), dtype=np.int32)
        ev_lane, ev_t, ev_kind, ev_src, ev_seq, ev_size = self._init_cols
        if ev_lane.size:
            # slot each event into its per-lane cumcount position
            order = np.argsort(ev_lane, kind="stable")
            l_s = ev_lane[order]
            counts = np.bincount(l_s, minlength=n)
            starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
            pos = np.arange(l_s.size) - np.repeat(starts, counts)
            q_time[l_s, pos] = ev_t[order]
            q_auxh[l_s, pos] = (ev_kind[order] << lanes.AUX_KIND_SHIFT) | (
                ev_src[order] << lanes.AUX_SRC_SHIFT
            )
            q_auxl[l_s, pos] = ev_seq[order]
            q_size[l_s, pos] = ev_size[order]
        # rows sorted by the 4-word key (np.lexsort: primary key last)
        order = np.lexsort((q_auxl, q_auxh, q_time), axis=1)
        q_time = np.take_along_axis(q_time, order, axis=1)
        q_auxh = np.take_along_axis(q_auxh, order, axis=1)
        q_auxl = np.take_along_axis(q_auxl, order, axis=1)
        q_size = np.take_along_axis(q_size, order, axis=1)
        q_thi, q_tlo = lanes.t_split(torch.from_numpy(q_time))

        dev = self.device

        def t32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)

        def zeros():
            return torch.zeros(n, dtype=torch.int32, device=dev)

        def scalar(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        # bucket state: next_refill one interval in (grid-aligned),
        # last_depart 0; CoDel first_above at the UNSET sentinel
        return lanes.LaneState(
            q_thi=t32(q_thi), q_tlo=t32(q_tlo), q_auxh=t32(q_auxh),
            q_auxl=t32(q_auxl), q_size=t32(q_size),
            send_seq=zeros(), local_seq=t32(self._local_seq0),
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
            n_delivered=zeros(), n_codel=zeros(), n_queue=zeros(),
            recv_bytes=zeros(), n_sends=zeros(),
            log=torch.zeros((max(p.log_capacity, 1), 6), dtype=torch.int64,
                            device=dev),
            log_count=scalar(0), log_lost=scalar(0),
            rounds=scalar(0), iters=scalar(0),
            now_we_hi=scalar(0), now_we_lo=scalar(0),
        )

    # -- running -----------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, mode: str = "device") -> SimResult:
        """``mode='device'``: the device loop, which reads the device's
        ``live`` flag every few steps; ``mode='step'``: one window per
        round, reading the flags after every iteration."""
        if mode not in ("device", "step"):
            raise ValueError(f"mode must be 'device' or 'step', got {mode!r}")
        state = self.initial_state()
        p, tb = self.params, self.tables
        if mode == "device":
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
        for fname in ("send_seq", "local_seq", "n_delivered", "n_sends",
                      "recv_bytes", "m_peer_offset"):
            if int(getattr(s, fname).min()) < 0:
                raise RuntimeError(
                    f"lane counter {fname} wrapped past 2**31; this run "
                    "exceeds the lane backend's int32 counter range"
                )
        n_queue_drops = int(s.n_queue.sum())
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
        event_log = [LogRecord(*row) for row in s.log[:log_count].tolist()]
        model = self.tables.model
        tgen = ((model == lanes.M_TGEN_MESH) | (model == lanes.M_TGEN_CLIENT)
                | (model == lanes.M_TGEN_SERVER))
        counters: dict[str, int] = {}

        def add(key: str, val: int) -> None:
            if val:
                counters[key] = counters.get(key, 0) + int(val)

        add("tgen_recv_bytes", int(s.recv_bytes[tgen].sum()))
        add("lane_iters", int(s.iters))
        add("lane_delivered", int(s.n_delivered.sum()))
        add("lane_drop_codel", int(s.n_codel.sum()))
        add("lane_drop_queue", n_queue_drops)
        add("lane_sends", int(s.n_sends.sum()))
        return SimResult(
            sim_time_ns=self.params.stop_time,
            wall_seconds=wall,
            rounds=int(s.rounds),
            event_log=event_log,
            counters=counters,
        )
