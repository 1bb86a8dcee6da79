"""setup_s (s): from the command's start to the release: the libraries'
build or load, the clients' start, weights, frames and warm-up."""


def read(facts):
    return facts['setup_s']
