"""Entry points of the port that are not the server: benches and checks."""
