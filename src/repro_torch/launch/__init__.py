"""Step functions: the train step."""
