"""Config parsing and logging of the port's CLIs."""
