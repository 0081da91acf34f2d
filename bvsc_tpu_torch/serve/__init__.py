"""Batched multi-stream serving and the BVSP/1 TCP daemon (port of
``bvsc_tpu/serve/``).

All exports are lazy, so that the client half (``CodecClient``,
``bvsc_tpu_torch.serve.protocol``) loads no engine.  The AOT serving
bundles and the native client are not ported (``ROADMAP.md``, queue 1,
item 9; ``bvsc_tpu``'s native C client talks to this daemon as it is).
"""

_LAZY = {
    "DecodeEngine": ("bvsc_tpu_torch.serve.engine", "DecodeEngine"),
    "ServingEngine": ("bvsc_tpu_torch.serve.engine", "ServingEngine"),
    "CodecDaemon": ("bvsc_tpu_torch.serve.daemon", "CodecDaemon"),
    "CodecClient": ("bvsc_tpu_torch.serve.client", "CodecClient"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(module), attr)
