from . import config5, density_image, evidence, make_ics, sod_evidence

__all__ = ["config5", "density_image", "evidence", "make_ics",
           "sod_evidence"]
