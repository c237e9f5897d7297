"""One driver per kind of job, named by a traffic file's ``driver``."""
