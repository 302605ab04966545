"""Ops: so far only the Adam updater the model train steps share."""
