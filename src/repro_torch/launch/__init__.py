"""Entry points of the port: serving step functions and the launcher."""
