"""Entry points of the port: the retrieval and video QA inference CLIs."""
