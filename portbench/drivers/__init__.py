"""One general driver per kind of mix (a mix file's ``kind``)."""
