"""The inverse-dynamics layer: the ADMM QP (`qp`) and the kinodynamics ID
(`kinodynamics_id`)."""
