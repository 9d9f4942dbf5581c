"""One loop per kind of entry point; a traffic file names its loop."""
