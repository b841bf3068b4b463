"""The file-system client: ``filesystem.HdrfClient``, striped EC files
(``striped``) and OAuth2 token providers (``oauth2``)."""
