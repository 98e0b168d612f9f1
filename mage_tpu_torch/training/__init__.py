"""Stage-2 training: the learning-rate schedules, the auto-beta PID
controller, checkpoints, and the MAGE train step and trainer."""
