"""Training, checkpoints and model loading of room_slam_torch."""
