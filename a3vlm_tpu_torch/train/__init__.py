"""Training of the port: losses, LoRA, the train step, schedules and the
epoch loop."""
