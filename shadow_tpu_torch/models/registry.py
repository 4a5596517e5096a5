"""Model registry: maps a config `processes[].path` to a scripted host
model builder (port of shadow_tpu/models/registry.py). The port carries
tgen; the reference's other models raise NotYetPorted."""

from __future__ import annotations

from shadow_tpu_torch.config.options import NotYetPorted
from shadow_tpu_torch.config.options import reject_unknown as _reject_unknown
from shadow_tpu_torch.simtime import parse_time_ns

# registered in the reference, not yet in the port
_NOT_YET_PORTED = ("phold", "bulk-tcp", "onion", "cdn", "gossip")


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


_REGISTRY = {
    "tgen": _build_tgen,
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
    if name in _NOT_YET_PORTED:
        raise NotYetPorted(f"model {name!r}")
    if name not in _REGISTRY:
        raise ValueError(unknown_model_error(name))
    return _REGISTRY[name](num_hosts, args)
