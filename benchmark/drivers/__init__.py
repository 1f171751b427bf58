"""One driver per traffic kind; a mix file under ``traffic/`` names its
driver and holds its parameters."""
