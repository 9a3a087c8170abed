from . import density_image, make_ics

__all__ = ["density_image", "make_ics"]
