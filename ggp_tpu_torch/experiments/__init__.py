"""The port's experiment scripts."""
