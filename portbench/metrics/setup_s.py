"""setup_s: seconds from the process's start to the window's start
(the corpus, the program's build and upload, the warm-up)."""


def read(rec: dict):
    return rec.get("setup_s")
