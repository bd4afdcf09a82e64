"""Launchers: serving (``serve``), training (``train``) and the join
service (``join_service``) of the port; the LM's meshes (``mesh``) and
their placements (``specs``)."""
