"""Typed exceptions of the PyTorch port (counterpart of
``xmtpu.utils.errors``; own classes, so the port never imports the JAX
package)."""


class XmtpuError(Exception):
    """Base class for all errors of the port."""


class ConfigError(XmtpuError, ValueError):
    """Invalid or inconsistent pipeline configuration.

    Also a ValueError, as in the JAX package: a bad config is bad input
    data, and callers that catch ValueError keep working."""


class DecodeError(XmtpuError, ValueError):
    """An input file could not be decoded.

    Also a ValueError, as in the JAX package: decode failures are bad
    input data, and callers that catch ValueError keep working."""


class DeviceError(XmtpuError, RuntimeError):
    """No CUDA device for an entry point that builds on ``cuda`` unless
    the caller names a device; ``device="cpu"`` asks for the plain
    torch twins on the CPU."""


class KernelBuildError(XmtpuError, RuntimeError):
    """A CUDA kernel source failed to build, or no CUDA compiler was
    found."""
