"""Batched multi-stream serving and the BVSP/1 TCP daemon (port of
``bvsc_tpu/serve/``).

All exports are lazy, so that the client half (``CodecClient``,
``bvsc_tpu_torch.serve.protocol``) loads no engine.  AOT serving bundles
(``export_serving_bundle``, ``ServingBundle``) are ``serve.export``'s.  The
native client is not ported: ``bvsc_tpu``'s native C client talks to this
daemon as it is.
"""

_LAZY = {
    "DecodeEngine": ("bvsc_tpu_torch.serve.engine", "DecodeEngine"),
    "ServingEngine": ("bvsc_tpu_torch.serve.engine", "ServingEngine"),
    "CodecDaemon": ("bvsc_tpu_torch.serve.daemon", "CodecDaemon"),
    "CodecClient": ("bvsc_tpu_torch.serve.client", "CodecClient"),
    "FORMAT": ("bvsc_tpu_torch.serve.export", "FORMAT"),
    "export_serving_bundle": ("bvsc_tpu_torch.serve.export", "export_serving_bundle"),
    "ServingBundle": ("bvsc_tpu_torch.serve.export", "ServingBundle"),
    "ExportedPacketCodec": ("bvsc_tpu_torch.serve.export", "ExportedPacketCodec"),
    "ExportedPacketDecoder": ("bvsc_tpu_torch.serve.export", "ExportedPacketDecoder"),
    "BundleServingEngine": ("bvsc_tpu_torch.serve.export", "BundleServingEngine"),
    "BundleDecodeEngine": ("bvsc_tpu_torch.serve.export", "BundleDecodeEngine"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(module), attr)
