"""The port's reader."""
