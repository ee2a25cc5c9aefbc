"""The closed loop: perception, NPC traffic, the autopilot teacher, scenario
setup and the fleet rollout (port of ``cilrs_tpu/agent``)."""
