"""Model registry: maps a config `processes[].path` to the function that
makes its scripted host model (port of shadow_tpu/models/registry.py).
Each rejects unknown args with a one-line config error; an unknown model
name lists the registered names with a closest-match hint."""

from __future__ import annotations

from shadow_tpu_torch.config.options import reject_unknown as _reject_unknown
from shadow_tpu_torch.simtime import parse_time_ns


def _take(args: dict, time_keys=(), int_keys=()) -> "tuple[dict, dict]":
    args = dict(args)
    kwargs = {}
    for key, attr in time_keys:
        if key in args:
            kwargs[attr] = parse_time_ns(args.pop(key))
    for key, attr in int_keys:
        if key in args:
            kwargs[attr] = int(args.pop(key))
    return args, kwargs


def _build_bulk_tcp(num_hosts: int, args: dict):
    from shadow_tpu_torch.models.bulk import BulkTcpModel
    from shadow_tpu_torch.transport.tcp import TcpParams

    args, kwargs = _take(
        args,
        time_keys=[("start", "start_ns")],
        int_keys=[
            ("pairs", "num_pairs"),
            ("total_bytes", "total_bytes"),
            ("port", "port"),
            ("client_port", "client_port"),
        ],
    )
    kwargs.setdefault("num_pairs", num_hosts // 2)
    tcp_kwargs = {}
    for k in ("num_sockets", "mss", "rcv_wnd", "init_cwnd_segs"):
        if k in args:
            tcp_kwargs[k] = int(args.pop(k))
    if tcp_kwargs:
        kwargs["tcp_params"] = TcpParams(**tcp_kwargs)
    _reject_unknown("model bulk-tcp args", args)
    return BulkTcpModel(num_hosts=num_hosts, **kwargs)


def _build_phold(num_hosts: int, args: dict):
    from shadow_tpu_torch.models.phold import PholdModel

    args, kwargs = _take(
        args,
        time_keys=[("min_delay", "min_delay_ns"), ("max_delay", "max_delay_ns")],
        int_keys=[("ball_bytes", "ball_bytes")],
    )
    _reject_unknown("model phold args", args)
    return PholdModel(num_hosts=num_hosts, **kwargs)


def _build_tgen(num_hosts: int, args: dict):
    from shadow_tpu_torch.models.tgen import TgenModel

    args = dict(args)
    if "clients" in args:
        clients = int(args.pop("clients"))
        servers = int(args.pop("servers", num_hosts - clients))
    elif "servers" in args:
        servers = int(args.pop("servers"))
        clients = num_hosts - servers
    else:
        clients = num_hosts // 2
        servers = num_hosts - clients
    args, kwargs = _take(
        args,
        time_keys=[("pause", "pause_ns"), ("start", "start_ns")],
        int_keys=[
            ("req_bytes", "req_bytes"),
            ("resp_bytes", "resp_bytes"),
            ("port", "port"),
        ],
    )
    _reject_unknown("model tgen args", args)
    return TgenModel(
        num_hosts=num_hosts, num_clients=clients, num_servers=servers, **kwargs
    )


def _build_onion(num_hosts: int, args: dict):
    from shadow_tpu_torch.models.overlay.onion import OnionModel

    args = dict(args)
    # relay consensus size first, clients take the rest (like tgen's split)
    if "relays" in args:
        relays = int(args.pop("relays"))
        clients = int(args.pop("clients", num_hosts - relays))
    elif "clients" in args:
        clients = int(args.pop("clients"))
        relays = num_hosts - clients
    else:
        relays = max(3, num_hosts // 4)
        clients = num_hosts - relays
    args, kwargs = _take(
        args,
        time_keys=[("pause", "pause_ns"), ("start", "start_ns"), ("tick", "tick_ns")],
        int_keys=[
            ("hops", "hops"),
            ("cell", "cell_bytes"),
            ("req_cells", "req_cells"),
            ("resp_cells", "resp_cells"),
            ("circuits", "circuits_per_relay"),
            ("cells_per_service", "cells_per_service"),
            ("inflight_cells", "inflight_cells"),
            ("port", "port"),
        ],
    )
    _reject_unknown("model onion args", args)
    return OnionModel(num_hosts=num_hosts, num_clients=clients, num_relays=relays, **kwargs)


def _build_cdn(num_hosts: int, args: dict):
    from shadow_tpu_torch.models.overlay.cdn import CdnModel

    args, kwargs = _take(
        args,
        time_keys=[("pause", "pause_ns"), ("start", "start_ns")],
        int_keys=[
            ("mids", "num_mids"),
            ("leaves", "num_leaves"),
            ("objects", "objects"),
            ("leaf_slots", "leaf_slots"),
            ("mid_slots", "mid_slots"),
            ("obj_bytes", "obj_bytes"),
            ("req_bytes", "req_bytes"),
        ],
    )
    _reject_unknown("model cdn args", args)
    return CdnModel(num_hosts=num_hosts, **kwargs)


def _build_gossip(num_hosts: int, args: dict):
    from shadow_tpu_torch.models.overlay.gossip import GossipModel

    args, kwargs = _take(
        args,
        time_keys=[("interval", "interval_ns"), ("start", "start_ns")],
        int_keys=[
            ("view", "view_size"),
            ("fanout", "fanout"),
            ("churn_ppm", "churn_ppm"),
            ("msg_bytes", "msg_bytes"),
        ],
    )
    _reject_unknown("model gossip args", args)
    return GossipModel(num_hosts=num_hosts, **kwargs)


_REGISTRY = {
    "phold": _build_phold,
    "bulk-tcp": _build_bulk_tcp,
    "tgen": _build_tgen,
    "onion": _build_onion,
    "cdn": _build_cdn,
    "gossip": _build_gossip,
}


def registered_models() -> "list[str]":
    return sorted(_REGISTRY)


def unknown_model_error(name: str) -> str:
    import difflib

    msg = f"unknown model {name!r}; registered models: {registered_models()}"
    close = difflib.get_close_matches(str(name), _REGISTRY, n=1)
    if close:
        msg += f" (did you mean {close[0]!r}?)"
    return msg


def build_model(name: str, num_hosts: int, args: dict):
    if name not in _REGISTRY:
        raise ValueError(unknown_model_error(name))
    return _REGISTRY[name](num_hosts, args)


def register_model(name: str, builder) -> None:
    """Add (or replace) the model a config's `processes[].path` names:
    `builder(num_hosts, args)` returns the scripted host model."""
    _REGISTRY[name] = builder
