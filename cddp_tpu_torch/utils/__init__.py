"""Helpers of the port that no solver needs (port of ``cddp_tpu/utils``):
``rotations``, the attitude conversions the quadrotor models use."""
