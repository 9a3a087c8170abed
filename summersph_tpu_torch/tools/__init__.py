from . import config5, density_image, make_ics

__all__ = ["config5", "density_image", "make_ics"]
