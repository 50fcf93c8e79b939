"""Image files: PFM, NPY, OpenEXR and PNG."""
