from .limbs import DeviceField

__all__ = ["DeviceField"]
