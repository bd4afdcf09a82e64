"""Launchers: the serving launcher (``serve``) of the dense LM."""
