"""The inverse-dynamics layer: the ADMM QP (`qp`), the kinodynamics ID
(`kinodynamics_id`) and the centroidal ID (`centroidal_id`)."""
